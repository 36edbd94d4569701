// Fused multi-task MLP kernels for Hopper (sm_90a), fp32 on CUDA cores.
//
// Two kernels share ONE device forward (forward_tile), as the Pallas
// kernels share _forward_tile:
//
//   fused_lookup_kernel  replaces src/repro/kernels/fused_mlp.py ::
//       make_fused_lookup_kernel, launched by fused_lookup_call (K1).
//       Raw int32 keys in; in-kernel digit/residue decomposition from the
//       (modulus, divisor) table; the whole model; per-task argmax codes
//       (forced to 0 outside [0, capacity)); existence bits from the
//       packed words; optional predicate match bits.
//   fused_mlp_kernel     replaces src/repro/kernels/fused_mlp.py ::
//       make_fused_kernel, launched by fused_mlp_call (K2).  Host digits
//       in; per-task argmax codes or padded logits out.
//
// The store's build evaluates T_aux through K2 and its lookups run through
// K1, so their codes must agree bit for bit.  Every row's arithmetic is
// therefore independent of the batch, of the block tile and of the row's
// place in it: each output element is summed by one thread in one fixed
// order (gather layer: positions 0..width-1, then + bias; dense layer:
// k = 0..in-1 with fmaf, then + bias).  No split-K, no atomics, no
// library GEMM.  The argmax is a comparison reduction over (value, index)
// with NaN above everything and ties to the lowest index (jnp.argmax's
// rule), which gives one answer whatever the reduction order.
//
// fp32 throughout, on CUDA cores.  wgmma/TF32 is deliberately out: TF32
// keeps ~3 decimal digits and would flip argmaxes against the plain fp32
// reference; bf16/TF32 with exactness checks is a later design question.
//
// What bounds it on this card: at the slice's shapes (width 8 gather,
// shared 256x256, four private 64-wide heads with cards 1000/5/3/1) the
// work is ~0.39 MFLOP of unpadded fp32 per key: 25.8 GFLOP per 65,536-key
// launch, ~0.38 ms at the H100 SXM's 67 TFLOP/s fp32 rate, against ~6 MB
// moved (keys, codes, 2.6 MB of padded weights, 1.5 MB of words).  It is
// compute-bound.  This simple design does nothing about that bound yet:
// weights are read from global memory (L2-resident: one padded 256x256
// layer is 256 KiB, above the 227 KB a block may use, so the Pallas
// design of VMEM-resident weights does not carry over), activations live
// in a shared-memory tile, and each thread keeps a register tile of up to
// 32 rows for one output column at a time.
//
// Plain C interface, loaded with ctypes (repro_torch/kernels/fused_mlp.py).
// Every entry returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr int MAX_LAYERS = 64;
constexpr int MAX_HEADS = 32;
constexpr int MAX_PREDS = 8;
constexpr int SMEM_LIMIT = 232448;  // 227 KB a block may use on sm_90

struct Layer {
  const float* w;  // padded weights: (in_pad, ld), or (width, base_pad, ld)
  const float* b;  // padded bias (ld,)
  int in_dim;      // real fan-in of a dense layer (0 for a gather layer)
  int out_dim;     // real fan-out
  int ld;          // padded fan-out: row stride of w
  int embed;       // 1: first layer from the input, evaluated as a gather
};

struct Head {
  int first;     // index of its first layer in Model::layers
  int count;     // hidden layers + out layer
  int card;      // real output columns: the argmax runs over these
  int card_pad;  // padded output columns (logits row stride)
};

struct Model {
  Layer layers[MAX_LAYERS];
  Head heads[MAX_HEADS];
  float* logits[MAX_HEADS];  // K2 logits outputs (emit_codes == 0)
  int n_trunk;
  int n_heads;
  int width;
  int base;
  int base_pad;
  int hstride;  // floats per activation row in shared memory (multiple of 4)
};

struct Preds {
  const int* tables[MAX_PREDS];
  int tasks[MAX_PREDS];
  int n;
};

// (value, index) order of the argmax: NaN first, then larger value, then
// lower index.  A strict total order, so any reduction order agrees.
__device__ __forceinline__ bool better(float v, int j, float bv, int bj) {
  if (isnan(bv)) return isnan(v) && j < bj;
  if (isnan(v)) return true;
  return v > bv || (v == bv && j < bj);
}

// Logits (bias included) of output column j for RM consecutive rows.
// x: the rows' input activations (row stride xs); dg: their digits.
template <int RM>
__device__ __forceinline__ void column(const Layer& L, int j, const float* x, int xs,
                                       const int* dg, int width, int base_pad,
                                       float (&acc)[RM]) {
#pragma unroll
  for (int i = 0; i < RM; ++i) acc[i] = 0.f;
  if (L.embed) {
    // Row gather W[p, d_p, j], summed in position order: exactly the
    // one-hot product of the Pallas kernel (the other terms are exact 0).
    for (int p = 0; p < width; ++p) {
      const float* wp = L.w + (size_t)p * base_pad * L.ld + j;
#pragma unroll
      for (int i = 0; i < RM; ++i) acc[i] += __ldg(wp + (size_t)dg[i * width + p] * L.ld);
    }
  } else {
    // k runs to in_dim rounded up to 4: the padded weight rows and the
    // activation columns past in_dim are exact zeros.
    const int k4 = (L.in_dim + 3) & ~3;
    for (int k = 0; k < k4; k += 4) {
      const float* wk = L.w + (size_t)k * L.ld + j;
      const float w0 = __ldg(wk);
      const float w1 = __ldg(wk + L.ld);
      const float w2 = __ldg(wk + 2 * (size_t)L.ld);
      const float w3 = __ldg(wk + 3 * (size_t)L.ld);
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const float4 xv = *reinterpret_cast<const float4*>(x + i * xs + k);
        float a = acc[i];
        a = fmaf(xv.x, w0, a);
        a = fmaf(xv.y, w1, a);
        a = fmaf(xv.z, w2, a);
        a = fmaf(xv.w, w3, a);
        acc[i] = a;
      }
    }
  }
  const float bj = __ldg(L.b + j);
#pragma unroll
  for (int i = 0; i < RM; ++i) acc[i] = acc[i] + bj;
}

// Hidden layer: y = relu(layer(x)) into shared memory.  Thread (rb, ct)
// owns rows rb*RM..rb*RM+RM-1 and columns ct, ct+CT, ...; columns from
// out_dim up to the next multiple of 4 are written as zeros.
template <int TILE, int RM>
__device__ void hidden_rm(const Layer& L, const float* x, float* y, int hs, const int* dg,
                          int width, int base_pad) {
  constexpr int NRB = TILE / RM;
  constexpr int CT = THREADS / NRB;
  const int rb = threadIdx.x / CT;
  const int ct = threadIdx.x % CT;
  const int r0 = rb * RM;
  const int out4 = (L.out_dim + 3) & ~3;
  for (int j = ct; j < out4; j += CT) {
    if (j < L.out_dim) {
      float acc[RM];
      column<RM>(L, j, x ? x + r0 * hs : nullptr, hs, dg + r0 * width, width, base_pad, acc);
#pragma unroll
      for (int i = 0; i < RM; ++i) y[(r0 + i) * hs + j] = fmaxf(acc[i], 0.f);
    } else {
#pragma unroll
      for (int i = 0; i < RM; ++i) y[(r0 + i) * hs + j] = 0.f;
    }
  }
}

// Out layer of head hi: argmax codes into s_codes, or logits to global.
template <int TILE, int RM>
__device__ void out_rm(const Layer& L, const Head& H, int hi, const float* x, int hs,
                       const int* dg, int width, int base_pad, bool emit_codes,
                       float* logits, int row0, int n, int* s_codes, int n_heads,
                       float* red_v, int* red_i) {
  constexpr int NRB = TILE / RM;
  constexpr int CT = THREADS / NRB;
  const int rb = threadIdx.x / CT;
  const int ct = threadIdx.x % CT;
  const int r0 = rb * RM;
  const float* xr = x ? x + r0 * hs : nullptr;
  const int* dr = dg + r0 * width;
  if (!emit_codes) {
    for (int j = ct; j < H.card_pad; j += CT) {
      float acc[RM];
      if (j < H.card) {
        column<RM>(L, j, xr, hs, dr, width, base_pad, acc);
      } else {
#pragma unroll
        for (int i = 0; i < RM; ++i) acc[i] = 0.f;  // zero-padded columns
      }
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int row = row0 + r0 + i;
        if (row < n) logits[(size_t)row * H.card_pad + j] = acc[i];
      }
    }
    return;
  }
  float bv[RM];
  int bi[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    bv[i] = -INFINITY;
    bi[i] = 0x7fffffff;
  }
  for (int j = ct; j < H.card; j += CT) {
    float acc[RM];
    column<RM>(L, j, xr, hs, dr, width, base_pad, acc);
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      if (better(acc[i], j, bv[i], bi[i])) {
        bv[i] = acc[i];
        bi[i] = j;
      }
    }
  }
  // Reduce over the CT threads of this row block: butterfly within each
  // warp, then one thread per row over the block's warps in order.
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv[i], off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi[i], off);
      if (better(ov, oi, bv[i], bi[i])) {
        bv[i] = ov;
        bi[i] = oi;
      }
    }
  }
  const int wi = ct / 32;  // warp index within the row block
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      red_v[wi * TILE + r0 + i] = bv[i];
      red_i[wi * TILE + r0 + i] = bi[i];
    }
  }
  __syncthreads();
  if (threadIdx.x < TILE) {
    const int r = threadIdx.x;
    float v = red_v[r];
    int ix = red_i[r];
    for (int w = 1; w < CT / 32; ++w) {
      if (better(red_v[w * TILE + r], red_i[w * TILE + r], v, ix)) {
        v = red_v[w * TILE + r];
        ix = red_i[w * TILE + r];
      }
    }
    s_codes[r * n_heads + hi] = ix;
  }
}

// Rows per thread for a layer of `cols` output columns: enough row
// blocks that the block's 256 threads all get columns.
__host__ __device__ constexpr int rm_for(int cols, int tile) {
  const int rm = cols >= 256 ? 32 : (cols >= 128 ? 16 : 8);
  return rm < tile ? rm : tile;
}

template <int TILE>
__device__ void hidden_layer(const Layer& L, const float* x, float* y, int hs, const int* dg,
                             int width, int base_pad) {
  const int rm = rm_for(L.out_dim, TILE);
  if (TILE >= 32 && rm == 32) {
    hidden_rm<TILE, (TILE >= 32 ? 32 : 8)>(L, x, y, hs, dg, width, base_pad);
  } else if (TILE >= 16 && rm == 16) {
    hidden_rm<TILE, (TILE >= 16 ? 16 : 8)>(L, x, y, hs, dg, width, base_pad);
  } else {
    hidden_rm<TILE, 8>(L, x, y, hs, dg, width, base_pad);
  }
}

template <int TILE>
__device__ void out_layer(const Layer& L, const Head& H, int hi, const float* x, int hs,
                          const int* dg, int width, int base_pad, bool emit_codes,
                          float* logits, int row0, int n, int* s_codes, int n_heads,
                          float* red_v, int* red_i) {
  const int rm = rm_for(H.card, TILE);
  if (TILE >= 32 && rm == 32) {
    out_rm<TILE, (TILE >= 32 ? 32 : 8)>(L, H, hi, x, hs, dg, width, base_pad, emit_codes,
                                        logits, row0, n, s_codes, n_heads, red_v, red_i);
  } else if (TILE >= 16 && rm == 16) {
    out_rm<TILE, (TILE >= 16 ? 16 : 8)>(L, H, hi, x, hs, dg, width, base_pad, emit_codes,
                                        logits, row0, n, s_codes, n_heads, red_v, red_i);
  } else {
    out_rm<TILE, 8>(L, H, hi, x, hs, dg, width, base_pad, emit_codes, logits, row0, n,
                    s_codes, n_heads, red_v, red_i);
  }
}

// Whole-model forward on one tile of TILE rows whose digits are in s_dg.
// Three activation buffers: two ping-pong through the trunk, then the one
// holding the trunk output stays while the other two serve each head.
template <int TILE>
__device__ void forward_tile(const Model& m, float* sbuf, const int* s_dg, int* s_codes,
                             float* red_v, int* red_i, bool emit_codes, int row0, int n) {
  const int hs = m.hstride;
  float* buf[3] = {sbuf, sbuf + TILE * hs, sbuf + 2 * TILE * hs};
  int xi = -1;
  for (int l = 0; l < m.n_trunk; ++l) {
    const int oi = (xi == 0) ? 1 : 0;
    hidden_layer<TILE>(m.layers[l], xi >= 0 ? buf[xi] : nullptr, buf[oi], hs, s_dg, m.width,
                       m.base_pad);
    __syncthreads();
    xi = oi;
  }
  const int ha = (xi == 0) ? 1 : 0;
  const int hb = (xi == 2 || xi == -1) ? 1 : 2;
  for (int h = 0; h < m.n_heads; ++h) {
    const Head& H = m.heads[h];
    int cur = xi;
    for (int c = 0; c + 1 < H.count; ++c) {
      const int oi = (c % 2 == 0) ? ha : hb;
      hidden_layer<TILE>(m.layers[H.first + c], cur >= 0 ? buf[cur] : nullptr, buf[oi], hs,
                         s_dg, m.width, m.base_pad);
      __syncthreads();
      cur = oi;
    }
    out_layer<TILE>(m.layers[H.first + H.count - 1], H, h, cur >= 0 ? buf[cur] : nullptr, hs,
                    s_dg, m.width, m.base_pad, emit_codes, m.logits[h], row0, n, s_codes,
                    m.n_heads, red_v, red_i);
    __syncthreads();
  }
}

// Shared-memory layout, in 4-byte words: 3 activation buffers, the argmax
// scratch (values, indices), codes, digits, (modulus, divisor) pairs.
template <int TILE>
__host__ __device__ constexpr size_t smem_words(int hstride, int width, int n_heads) {
  return (size_t)3 * TILE * hstride + 2 * (size_t)NWARPS * TILE + (size_t)TILE * n_heads +
         (size_t)TILE * width + 2 * (size_t)width;
}

struct Smem {
  float* buf;
  float* red_v;
  int* red_i;
  int* codes;
  int* dg;
  int* ops;
};

template <int TILE>
__device__ Smem carve(float* smem, const Model& m) {
  Smem s;
  s.buf = smem;
  s.red_v = s.buf + 3 * TILE * m.hstride;
  s.red_i = reinterpret_cast<int*>(s.red_v + NWARPS * TILE);
  s.codes = s.red_i + NWARPS * TILE;
  s.dg = s.codes + TILE * m.n_heads;
  s.ops = s.dg + TILE * m.width;
  return s;
}

template <int TILE>
__global__ void __launch_bounds__(THREADS)
    fused_lookup_kernel(const __grid_constant__ Model m, const int* __restrict__ keys, int n,
                        const int* __restrict__ pos_ops, long long capacity,
                        const unsigned* __restrict__ words, int n_words, int with_exists,
                        const __grid_constant__ Preds preds, int* __restrict__ codes, int* __restrict__ exists,
                        int* __restrict__ match) {
  extern __shared__ __align__(16) float smem[];
  const Smem s = carve<TILE>(smem, m);
  const int row0 = blockIdx.x * TILE;
  for (int i = threadIdx.x; i < 2 * m.width; i += THREADS) s.ops[i] = pos_ops[i];
  __syncthreads();
  // In-kernel digit/residue decomposition: digit p is
  // ((k % mod_p) / div_p) % base, on keys clamped to 0 outside capacity.
  for (int idx = threadIdx.x; idx < TILE * m.width; idx += THREADS) {
    const int r = idx / m.width;
    const int p = idx - r * m.width;
    const int row = row0 + r;
    const int k = row < n ? keys[row] : -1;
    const int safe = (k >= 0 && (long long)k < capacity) ? k : 0;
    s.dg[idx] = ((safe % s.ops[2 * p]) / s.ops[2 * p + 1]) % m.base;
  }
  __syncthreads();
  forward_tile<TILE>(m, s.buf, s.dg, s.codes, s.red_v, s.red_i, true, row0, n);
  if (threadIdx.x < TILE) {
    const int r = threadIdx.x;
    const int row = row0 + r;
    if (row < n) {
      const int k = keys[row];
      const bool in_cap = k >= 0 && (long long)k < capacity;
      for (int h = 0; h < m.n_heads; ++h)
        codes[(size_t)row * m.n_heads + h] = in_cap ? s.codes[r * m.n_heads + h] : 0;
      if (with_exists) {
        // Bits past the bitvector's capacity are never set, so the word
        // domain alone reproduces BitVector.test.
        int e = 0;
        if (k >= 0 && (k >> 5) < n_words) e = (int)((words[k >> 5] >> (k & 31)) & 1u);
        exists[row] = e;
        if (preds.n) {
          int mm = e;
          for (int j = 0; j < preds.n; ++j) {
            const int c = in_cap ? s.codes[r * m.n_heads + preds.tasks[j]] : 0;
            mm *= preds.tables[j][c];
          }
          match[row] = mm;
        }
      }
    }
  }
}

template <int TILE>
__global__ void __launch_bounds__(THREADS)
    fused_mlp_kernel(const __grid_constant__ Model m, const int* __restrict__ digits, int n, int emit_codes,
                     int* __restrict__ codes) {
  extern __shared__ __align__(16) float smem[];
  const Smem s = carve<TILE>(smem, m);
  const int row0 = blockIdx.x * TILE;
  for (int idx = threadIdx.x; idx < TILE * m.width; idx += THREADS) {
    const int r = idx / m.width;
    const int row = row0 + r;
    s.dg[idx] = row < n ? digits[(size_t)row0 * m.width + idx] : 0;
  }
  __syncthreads();
  forward_tile<TILE>(m, s.buf, s.dg, s.codes, s.red_v, s.red_i, emit_codes != 0, row0, n);
  if (emit_codes && threadIdx.x < TILE) {
    const int r = threadIdx.x;
    const int row = row0 + r;
    if (row < n) {
      for (int h = 0; h < m.n_heads; ++h)
        codes[(size_t)row * m.n_heads + h] = s.codes[r * m.n_heads + h];
    }
  }
}

int fill_model(Model* m, const long long* w_ptrs, const long long* b_ptrs,
               const int* layer_info, int n_layers, int n_trunk, const int* head_info,
               int n_heads, int width, int base, int base_pad, int hstride,
               const long long* logit_ptrs) {
  if (n_layers > MAX_LAYERS || n_heads > MAX_HEADS || hstride % 4 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  for (int l = 0; l < n_layers; ++l) {
    Layer& L = m->layers[l];
    L.w = reinterpret_cast<const float*>(w_ptrs[l]);
    L.b = reinterpret_cast<const float*>(b_ptrs[l]);
    L.in_dim = layer_info[4 * l + 0];
    L.out_dim = layer_info[4 * l + 1];
    L.ld = layer_info[4 * l + 2];
    L.embed = layer_info[4 * l + 3];
  }
  for (int h = 0; h < n_heads; ++h) {
    Head& H = m->heads[h];
    H.first = head_info[4 * h + 0];
    H.count = head_info[4 * h + 1];
    H.card = head_info[4 * h + 2];
    H.card_pad = head_info[4 * h + 3];
    m->logits[h] = logit_ptrs ? reinterpret_cast<float*>(logit_ptrs[h]) : nullptr;
  }
  m->n_trunk = n_trunk;
  m->n_heads = n_heads;
  m->width = width;
  m->base = base;
  m->base_pad = base_pad;
  m->hstride = hstride;
  return 0;
}

// The widest tile whose shared memory fits: 32 rows, else 8.
int pick_tile(const Model& m, size_t* bytes) {
  const size_t b32 = 4 * smem_words<32>(m.hstride, m.width, m.n_heads);
  if (b32 <= SMEM_LIMIT) {
    *bytes = b32;
    return 32;
  }
  *bytes = 4 * smem_words<8>(m.hstride, m.width, m.n_heads);
  return *bytes <= SMEM_LIMIT ? 8 : 0;
}

}  // namespace

extern "C" {

const char* repro_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

int repro_fused_lookup(const long long* w_ptrs, const long long* b_ptrs, const int* layer_info,
                       int n_layers, int n_trunk, const int* head_info, int n_heads, int width,
                       int base, int base_pad, int hstride, const void* keys, int n,
                       const void* pos_ops, long long capacity, const void* words, int n_words,
                       int with_exists, const long long* pred_ptrs, const int* pred_tasks,
                       int n_preds, void* codes, void* exists, void* match, void* stream) {
  Model m;
  int err = fill_model(&m, w_ptrs, b_ptrs, layer_info, n_layers, n_trunk, head_info, n_heads,
                       width, base, base_pad, hstride, nullptr);
  if (err) return err;
  if (n_preds > MAX_PREDS) return (int)cudaErrorInvalidValue;
  Preds p;
  p.n = n_preds;
  for (int j = 0; j < n_preds; ++j) {
    p.tables[j] = reinterpret_cast<const int*>(pred_ptrs[j]);
    p.tasks[j] = pred_tasks[j];
  }
  size_t bytes = 0;
  const int tile = pick_tile(m, &bytes);
  if (tile == 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const auto* k = static_cast<const int*>(keys);
  const auto* ops = static_cast<const int*>(pos_ops);
  const auto* wd = static_cast<const unsigned*>(words);
  auto* c = static_cast<int*>(codes);
  auto* e = static_cast<int*>(exists);
  auto* mt = static_cast<int*>(match);
  if (tile == 32) {
    err = (int)cudaFuncSetAttribute(fused_lookup_kernel<32>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err) return err;
    fused_lookup_kernel<32><<<(n + 31) / 32, THREADS, bytes, st>>>(
        m, k, n, ops, capacity, wd, n_words, with_exists, p, c, e, mt);
  } else {
    err = (int)cudaFuncSetAttribute(fused_lookup_kernel<8>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err) return err;
    fused_lookup_kernel<8><<<(n + 7) / 8, THREADS, bytes, st>>>(
        m, k, n, ops, capacity, wd, n_words, with_exists, p, c, e, mt);
  }
  return (int)cudaGetLastError();
}

int repro_fused_mlp(const long long* w_ptrs, const long long* b_ptrs, const int* layer_info,
                    int n_layers, int n_trunk, const int* head_info, int n_heads, int width,
                    int base, int base_pad, int hstride, const void* digits, int n,
                    int emit_codes, void* codes, const long long* logit_ptrs, void* stream) {
  Model m;
  int err = fill_model(&m, w_ptrs, b_ptrs, layer_info, n_layers, n_trunk, head_info, n_heads,
                       width, base, base_pad, hstride, emit_codes ? nullptr : logit_ptrs);
  if (err) return err;
  size_t bytes = 0;
  const int tile = pick_tile(m, &bytes);
  if (tile == 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const auto* d = static_cast<const int*>(digits);
  auto* c = static_cast<int*>(codes);
  if (tile == 32) {
    err = (int)cudaFuncSetAttribute(fused_mlp_kernel<32>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err) return err;
    fused_mlp_kernel<32><<<(n + 31) / 32, THREADS, bytes, st>>>(m, d, n, emit_codes, c);
  } else {
    err = (int)cudaFuncSetAttribute(fused_mlp_kernel<8>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err) return err;
    fused_mlp_kernel<8><<<(n + 7) / 8, THREADS, bytes, st>>>(m, d, n, emit_codes, c);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
