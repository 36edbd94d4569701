// Fused multi-task MLP kernels for Hopper (sm_90a), fp32 on CUDA cores.
//
// Two kernels share ONE device forward (forward), as the Pallas kernels
// share _forward_tile:
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
// Numerics.  The store's build evaluates T_aux through K2 and its lookups
// run through K1, so their codes must agree bit for bit.  Every row's
// arithmetic is therefore independent of the batch, of the tile and of
// the row's place in it: each output element is summed by one thread in
// one fixed order (gather layer: positions 0..width-1 from 0.f, then
// + bias; dense layer: fmaf over k = 0..in-1 from 0.f, then + bias; ReLU
// is fmaxf(x, 0)).  The k-slab loop carries the same accumulator
// register across slabs, so the order is the one of a plain loop.  No
// split-K, no atomics, no library GEMM, no TF32/bf16 and no mma/wgmma:
// T_aux is correct only for the codes the deployed forward gives, and
// tensor cores round every logit differently.  The argmax is a reduction
// under better()'s strict total order over (value, index) -- NaN first,
// then the larger value, then the lower index (jnp.argmax's rule) -- so
// any reduction order gives one answer; it compares floats, never bit
// images, so -0 == +0 ties go to the lower index and +-inf order as
// values.
//
// What bounds it.  At the store's shape (PAPER_STORE: width 8 gather,
// shared 256x256, four private 64-wide heads, cards 1000/5/3/1) the work
// is 393,344 FLOP of unpadded fp32 per key: 25.8 GFLOP per 65,536-key
// launch, 0.385 ms at the H100 SXM's 67 TFLOP/s fp32, against ~6 MB
// moved.  It is bound by fp32 operations.  So the design is about FFMA
// issue: each thread owns an RM x CN (rows x columns) register micro-tile
// and, per k, reads RM activations (broadcast float4 loads: the rows of a
// warp are the same) and CN weights (float4 loads, neighbouring threads
// on neighbouring columns) for RM*CN FFMAs.  Activations live in shared
// memory feature-major, x[feature][row] with row stride xs, so the RM
// rows of one feature are one vector load.
//
// Tiles (TilePlan in repro_torch/kernels/fused_mlp.py computes the plan;
// the entries here only check it).  The full and mid tiles stage the
// weights of a pass through shared memory in k-slabs of PASS columns, two
// stages filled by cp.async while the previous slab's FFMAs run, so a
// block fetches each weight from L2 once for all its row groups; the plan
// takes the deepest slab of 32, 16 or 8 k-rows that fits beside the
// activations (deeper ran faster on both, PERF.md).  The narrow tile
// takes 8-row slabs where they fit, else reads weights from L2 (slab 0):
// it is bound by L2 bandwidth, 16-row slabs ran slower than 8-row ones
// there, and only its instantiation carries the L2 path (compiled into
// the full tile, that path slowed its slab loop by 5%).  Activation rows
// below are for width 8 and four heads.
//
//   full    128 rows, 16 x 8 micro-tile (a warp is one 16-row group over
//           256 columns).  16 x 8 needs 24 floats of shared reads per 128
//           FFMAs where 8 x 8 needs 16 per 64.  The activation buffer is
//           256 x 132 floats (132 KB) at the store's shape, beside 64 KB
//           of 32-row slabs.  Up to 303 activation rows with 32-row slabs,
//           396 with 8-row ones: hidden widths up to 256 with the heads
//           together (a layer of at most 256 columns is one pass, so it
//           can write over the inputs that die in it).
//   mid     32 rows, 8 x 4 (four 8-row groups over 256 columns).  Up to
//           1,143 activation rows with 32-row slabs, 1,484 with 8-row
//           ones: the store's heads under two-layer trunks up to 742
//           wide.  The previous design ran hidden widths up to about 590
//           at 32 rows; of those, models with wide heads (private
//           (576, 576)) take narrow here, which is faster on them than
//           that design was (PERF.md).  A 32 x 4 micro-tile (one row
//           group over 1,024 columns, in-place writes up to 1,024
//           columns) was slower on shared (512, 512) and is not kept.
//   narrow  8 rows, 8 x 4 (one row group over 1,024 columns), no row
//           pad.  Up to 5,185 activation rows with 8-row slabs and 7,233
//           from L2: hidden widths up to 2,400 with private depth 2 (the
//           previous design's 8-row limit).
//
// A thread none of whose quads holds a real column in a pass (the wide
// tiles' passes are wider than a head's layers) skips its FFMAs; it still
// copies its share of the slabs and meets every barrier.
//
// The schedule.  The plan runs the layers as groups: each trunk layer is
// one group; with the heads together, each depth of the heads' hidden
// layers is one group (a GEMM over their concatenated columns: the
// store's four 64-wide first layers are one 256-column pass from the
// trunk output) and all out layers form the last group, walked in passes
// of the micro-tile's width, so the tiny heads (cards 5, 3, 1) ride in
// the pass o_clerk's last 232 columns leave partly empty.  Each member of
// a group reads its own input rows (per-quad source rows); columns of a
// member are padded to 4 so a float4 quad never spans two members.  Past
// a member's fan-in, a quad reads a zero activation row and zero
// weights: fmaf(0, 0, acc) is acc exactly (acc starts at +0.f and so is
// never -0.f).
//
// The argmax, per pass and head: each thread folds its columns of the
// head (it meets them in ascending order, so after() stands for
// better()), a transposed butterfly reduces the RM rows across the warp
// (a lane hands half its rows to its partner at each step: 16 rows in 16
// exchanges, not 80), the warps of a row group merge through shared
// memory where a group spans several, and the one thread that owns a
// row keeps the head's running best in two registers across passes.  No
// running best is live during the k loops, whose accumulators need the
// registers.  The compares are written as selects: as branches they
// diverge per element, and the fold alone took longer than a 64-deep
// k loop.
//
// In-place writes: a hidden group of one pass may write over the inputs
// that die in it.  run_group's __syncthreads between the k loop and the
// writes separates the last read of those inputs from the first write;
// the one at the end of every pass orders the writes before the next
// group's reads.
//
// Plain C interface, loaded with ctypes (repro_torch/kernels/fused_mlp.py).
// Every entry returns cudaErrorInvalidValue for a plan that does not fit
// its layout, else cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_LAYERS = 64;
constexpr int MAX_HEADS = 32;
constexpr int MAX_PREDS = 8;
constexpr int STAGES = 2;
constexpr int SMEM_LIMIT = 232448;  // 227 KB a block may use on sm_90

struct Layer {
  const float* w;  // padded weights: (in_pad, ld), or (width, base_pad, ld)
  const float* b;  // padded bias (ld,)
  int in_dim;      // real fan-in of a dense layer (0 for a gather layer)
  int out_dim;     // real fan-out (the card for an out layer)
  int ld;          // padded fan-out: row stride of w
  int embed;       // 1: first layer from the input, evaluated as a gather
};

struct Head {
  int first;     // index of its first layer
  int count;     // hidden layers + out layer
  int card;      // real output columns: the argmax runs over these
  int card_pad;  // padded output columns (logits row stride)
};

// One layer in a group: its columns start at `col` of the group; it reads
// activation rows src.. (-1: gathers from the digits) and writes rows
// dst.. (-1 for an out layer).
struct Member {
  int layer, head, col, src, dst;
};

struct Group {
  int first, count;  // its members
  int cols;          // columns: the members' fan-outs rounded up to 4
  int out;           // 1: head out layers (argmax or logits)
};

struct Model {
  Layer layers[MAX_LAYERS];
  Head heads[MAX_HEADS];
  float* logits[MAX_HEADS];  // K2 logits outputs (emit_codes == 0)
  Member members[MAX_LAYERS];
  Group groups[MAX_LAYERS];
  int n_groups;
  int n_heads;
  int width;
  int base;
  int base_pad;
  int cap;  // activation rows (features) in shared memory, plus one zero row
  int xs;   // floats per activation row (the tile's rows plus a pad)
  int slab; // k-rows per staged weight slab (0: weights are read from L2)
};

struct Preds {
  const int* tables[MAX_PREDS];
  int tasks[MAX_PREDS];
  int n;
};

// (value, index) order of the argmax: NaN first, then larger value, then
// lower index.  A strict total order, so any reduction order agrees.
__device__ __forceinline__ bool better(float v, int j, float bv, int bj) {
  const bool nv = isnan(v), nb = isnan(bv), lower = j < bj;
  return nb ? (nv & lower) : (nv | (v > bv) | ((v == bv) & lower));
}

// better(v, j, bv, bj) for a j above bj, or for bj the start value
// 0x7fffffff (which every candidate beats).
__device__ __forceinline__ bool after(float v, float bv, int bj) {
  return (v > bv) | (isnan(v) & !isnan(bv)) | (bj == 0x7fffffff);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool full) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(full ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Shared-memory layout in 4-byte words; _smem_words in fused_mlp.py is
// the same sum.
template <int TILE, int RM, int CN>
struct Shape {
  static constexpr int TC = THREADS / (TILE / RM);  // column threads of a row group
  static constexpr int PASS = TC * CN;               // columns per pass
  static constexpr int NQ = CN / 4;                  // float4 quads per thread
  static constexpr int NW = TC / 32;                 // warps per row group
  // Only the narrow tile reads weights from L2 (slab 0): compiled into
  // the full tile, that path slowed its slab loop by 5%.
  static constexpr bool FROM_L2 = TILE == 8;
  static size_t words(int cap, int xs, int slab, int width, int n_heads) {
    return (size_t)(cap + 1) * xs + (size_t)STAGES * slab * PASS + (size_t)TILE * width +
           2 * (size_t)width + (size_t)TILE * n_heads + (NW > 1 ? 2 * (size_t)NW * TILE : 0);
  }
};

struct Smem {
  float* buf;   // activations, cap rows of xs floats, then the zero row
  float* slab;  // STAGES weight slabs of m.slab x PASS floats
  int* dg;      // digits, TILE x width
  int* ops;     // (modulus, divisor) per position
  int* codes;   // TILE x n_heads
  float* red_v; // cross-warp argmax scratch, NW x TILE
  int* red_i;
};

template <int TILE, int RM, int CN>
__device__ Smem carve(float* smem, const Model& m) {
  using S = Shape<TILE, RM, CN>;
  Smem s;
  s.buf = smem;
  s.slab = s.buf + (size_t)(m.cap + 1) * m.xs;
  s.dg = reinterpret_cast<int*>(s.slab + (size_t)STAGES * m.slab * S::PASS);
  s.ops = s.dg + TILE * m.width;
  s.codes = s.ops + 2 * m.width;
  s.red_v = reinterpret_cast<float*>(s.codes + TILE * m.n_heads);
  s.red_i = reinterpret_cast<int*>(s.red_v + S::NW * TILE);
  return s;
}

// The four columns col..col+3 of a group, as one thread sees them.
struct Quad {
  const float* w;  // weights of column j (dense: row 0; gather: position 0, digit 0)
  const float* b;  // bias of column j
  int ld;
  int kin;   // fan-in (gather: positions); 0 when no column is real
  int src;   // activation row of k = 0
  int j;     // column within the member's layer
  int out;   // real columns of the layer
  int dst;   // activation row of column j (hidden groups)
  int head;
};

__device__ __forceinline__ Quad quad_at(const Model& m, const Group& g, int col) {
  Quad q;
  q.w = m.layers[0].w;  // a valid address for the copies that read nothing
  q.b = nullptr;
  q.ld = q.kin = q.src = q.j = q.out = q.dst = q.head = 0;
  if (col >= g.cols) return q;
  for (int i = g.first; i < g.first + g.count; ++i) {
    const Member& M = m.members[i];
    const Layer& L = m.layers[M.layer];
    if (col < M.col + ((L.out_dim + 3) & ~3)) {
      q.j = col - M.col;
      q.w = L.w + q.j;
      q.b = L.b + q.j;
      q.ld = L.ld;
      q.kin = L.embed ? m.width : L.in_dim;
      q.src = M.src;
      q.out = L.out_dim;
      q.dst = M.dst + q.j;
      q.head = M.head;
      break;
    }
  }
  return q;
}

// Best (value, index) of each of a thread's RM rows over the TC column
// threads of its row group, by a transposed butterfly: at each of the
// first log2(RM) steps a lane hands half of its rows to its partner and
// keeps the other half, so a warp reduces RM rows in RM - 1 + log2(32/RM)
// exchanges instead of 5 * RM; the remaining steps are plain butterflies.
// Where a row group spans warps, one thread per row then merges the
// warps.  Returns true in the one thread that owns a row afterwards, with
// the row (within the tile) and its best.  Every thread of the block
// calls it.
template <int RM, int H, int O>
__device__ __forceinline__ void exchange(float (&bv)[RM], int (&bi)[RM], int lane, int& base) {
  if constexpr (O >= 1) {
    const bool up = lane & O;
#pragma unroll
    for (int r = 0; r < (H > 0 ? H : 1); ++r) {
      const int lo = r, hi = H > 0 ? r + H : r;
      const float sv = up ? bv[lo] : bv[hi];
      const int si = up ? bi[lo] : bi[hi];
      float kv = up ? bv[hi] : bv[lo];
      int ki = up ? bi[hi] : bi[lo];
      const float ov = __shfl_xor_sync(0xffffffffu, sv, O);
      const int oi = __shfl_xor_sync(0xffffffffu, si, O);
      const bool t = better(ov, oi, kv, ki);
      bv[r] = t ? ov : kv;
      bi[r] = t ? oi : ki;
    }
    if (H > 0 && up) base += H;
    exchange<RM, H / 2, O / 2>(bv, bi, lane, base);
  }
}

template <int TILE, int RM, int CN>
__device__ bool reduce_rows(float (&bv)[RM], int (&bi)[RM], const Smem& s, int r0, int& row,
                            float& v, int& ix) {
  using S = Shape<TILE, RM, CN>;
  const int lane = threadIdx.x & 31;
  int base = 0;
  exchange<RM, RM / 2, 16>(bv, bi, lane, base);
  const bool owner = (lane & (32 / RM - 1)) == 0;
  if constexpr (S::NW == 1) {
    row = r0 + base;
    v = bv[0];
    ix = bi[0];
    return owner;
  }
  const int wi = (threadIdx.x % S::TC) / 32;
  if (owner) {
    s.red_v[wi * TILE + r0 + base] = bv[0];
    s.red_i[wi * TILE + r0 + base] = bi[0];
  }
  __syncthreads();
  row = threadIdx.x;
  if (row < TILE) {
    v = s.red_v[row];
    ix = s.red_i[row];
    for (int w = 1; w < S::NW; ++w) {
      if (better(s.red_v[w * TILE + row], s.red_i[w * TILE + row], v, ix)) {
        v = s.red_v[w * TILE + row];
        ix = s.red_i[w * TILE + row];
      }
    }
  }
  __syncthreads();
  return row < TILE;
}

// The gather layer of one pass: W[p, d_p, j] summed in position order,
// exactly the one-hot product of the Pallas kernel (the other terms are
// exact 0).
template <int TILE, int RM, int CN>
__device__ __forceinline__ void gather_pass(float (&acc)[RM][CN], const Model& m,
                                            const Group& g, const Smem& s, int p0) {
  using S = Shape<TILE, RM, CN>;
  const int tc = threadIdx.x % S::TC;
  const int r0 = (threadIdx.x / S::TC) * RM;
#pragma unroll
  for (int q = 0; q < S::NQ; ++q) {
    const Quad Q = quad_at(m, g, p0 + (q * S::TC + tc) * 4);
    if (!Q.kin) continue;
    for (int p = 0; p < m.width; ++p) {
      const float* wp = Q.w + (size_t)p * m.base_pad * Q.ld;
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const float4 w4 = __ldg(
            reinterpret_cast<const float4*>(wp + (size_t)s.dg[(r0 + i) * m.width + p] * Q.ld));
        acc[i][4 * q + 0] += w4.x;
        acc[i][4 * q + 1] += w4.y;
        acc[i][4 * q + 2] += w4.z;
        acc[i][4 * q + 3] += w4.w;
      }
    }
  }
}

// The dense k loop of one pass: acc = fmaf(x[k], W[k], acc) for k
// ascending.  ONE: every quad of the pass reads the same activation rows
// with the same fan-in, so a thread loads each activation vector once for
// all its quads.
template <int TILE, int RM, int CN, bool ONE>
__device__ __forceinline__ void dense_pass(float (&acc)[RM][CN], const Model& m, const Group& g,
                                           const Smem& s, int p0, int K) {
  using S = Shape<TILE, RM, CN>;
  constexpr int NQ = S::NQ;
  const int tc = threadIdx.x % S::TC;
  const int r0 = (threadIdx.x / S::TC) * RM;
  const float* zrow = s.buf + (size_t)m.cap * m.xs + r0;
  const float* xb[NQ];
  const float* wq[NQ];
  int kin[NQ], ld[NQ];
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    const Quad Q = quad_at(m, g, p0 + (q * S::TC + tc) * 4);
    xb[q] = s.buf + (size_t)Q.src * m.xs + r0;
    wq[q] = Q.w;
    kin[q] = Q.kin;
    ld[q] = Q.ld;
  }
  auto step = [&](int k, const float4 (&w4)[NQ]) {
    const float* xp[NQ];
#pragma unroll
    for (int q = 0; q < NQ; ++q) xp[q] = k < kin[q] ? xb[q] + (size_t)k * m.xs : zrow;
#pragma unroll
    for (int i = 0; i < RM; i += 4) {
      float4 v = *reinterpret_cast<const float4*>(xp[0] + i);
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        if (q > 0 && !ONE) v = *reinterpret_cast<const float4*>(xp[q] + i);
        const float xr[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          acc[i + r][4 * q + 0] = fmaf(xr[r], w4[q].x, acc[i + r][4 * q + 0]);
          acc[i + r][4 * q + 1] = fmaf(xr[r], w4[q].y, acc[i + r][4 * q + 1]);
          acc[i + r][4 * q + 2] = fmaf(xr[r], w4[q].z, acc[i + r][4 * q + 2]);
          acc[i + r][4 * q + 3] = fmaf(xr[r], w4[q].w, acc[i + r][4 * q + 3]);
        }
      }
    }
  };
  // A thread none of whose quads holds a real column has no FFMAs to
  // issue in this pass (it still copies its share of the slabs).
  bool busy = false;
#pragma unroll
  for (int q = 0; q < NQ; ++q) busy = busy || kin[q] > 0;
  const int kslab = m.slab;
  if (kslab > 0) {
    // Thread t copies quad t % (PASS/4) of slab rows t / (PASS/4),
    // + THREADS / (PASS/4), ...; rows past the quad's fan-in are filled
    // with zeros.
    constexpr int LQ = S::PASS / 4;
    constexpr int ROW_STEP = THREADS / LQ;
    const Quad lq = quad_at(m, g, p0 + (threadIdx.x % LQ) * 4);
    const int lrow = threadIdx.x / LQ;
    float* lcol = s.slab + (threadIdx.x % LQ) * 4;
    auto load = [&](int sl) {
      float* dst = lcol + (sl & 1) * kslab * S::PASS;
      for (int r = lrow; r < kslab; r += ROW_STEP) {
        const int k = sl * kslab + r;
        const bool on = k < lq.kin;
        cp_async16(dst + r * S::PASS, on ? lq.w + (size_t)k * lq.ld : lq.w, on);
      }
      cp_async_commit();
    };
    const int nsl = (K + kslab - 1) / kslab;
    load(0);
    for (int sl = 0; sl < nsl; ++sl) {
      if (sl + 1 < nsl) {
        load(sl + 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const float* sw = s.slab + (sl & 1) * kslab * S::PASS + tc * 4;
      const int kn = busy ? min(kslab, K - sl * kslab) : 0;
      for (int kk = 0; kk < kn; ++kk) {
        float4 w4[NQ];
#pragma unroll
        for (int q = 0; q < NQ; ++q)
          w4[q] = *reinterpret_cast<const float4*>(sw + kk * S::PASS + q * S::TC * 4);
        step(sl * kslab + kk, w4);
      }
      __syncthreads();  // the next copy into this stage waits for these reads
    }
  } else if constexpr (S::FROM_L2) {
    if (!busy) return;
    for (int k = 0; k < K; ++k) {
      float4 w4[NQ];
#pragma unroll
      for (int q = 0; q < NQ; ++q)
        w4[q] = k < kin[q] ? __ldg(reinterpret_cast<const float4*>(wq[q] + (size_t)k * ld[q]))
                           : make_float4(0.f, 0.f, 0.f, 0.f);
      step(k, w4);
    }
  }
}

// One group of layers over the tile, in passes of PASS columns.
template <int TILE, int RM, int CN>
__device__ void run_group(const Model& m, const Group& g, const Smem& s, bool emit_codes,
                          int row0, int n) {
  using S = Shape<TILE, RM, CN>;
  constexpr int NQ = S::NQ;
  const int tc = threadIdx.x % S::TC;
  const int r0 = (threadIdx.x / S::TC) * RM;
  const bool gather = m.layers[m.members[g.first].layer].embed;
  int K = 0;
  for (int i = g.first; i < g.first + g.count; ++i) {
    const Layer& L = m.layers[m.members[i].layer];
    K = max(K, L.embed ? m.width : L.in_dim);
  }
  // The running best of the row this thread owns in the argmax, for the
  // head whose columns continue into the next pass.
  float run_v = 0.f;
  int run_i = 0;
  for (int p0 = 0; p0 < g.cols; p0 += S::PASS) {
    float acc[RM][CN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int c = 0; c < CN; ++c) acc[i][c] = 0.f;
    if (gather) {
      gather_pass<TILE, RM, CN>(acc, m, g, s, p0);
    } else if constexpr (NQ == 1) {
      dense_pass<TILE, RM, CN, true>(acc, m, g, s, p0, K);
    } else {
      // Do the members that meet this pass all read the same rows?
      int src = -2, kin = -2;
      bool one = true;
      for (int i = g.first; i < g.first + g.count; ++i) {
        const Member& M = m.members[i];
        const Layer& L = m.layers[M.layer];
        if (M.col + ((L.out_dim + 3) & ~3) <= p0 || M.col >= p0 + S::PASS) continue;
        if (src == -2) {
          src = M.src;
          kin = L.in_dim;
        }
        one = one && M.src == src && L.in_dim == kin;
      }
      if (one)
        dense_pass<TILE, RM, CN, true>(acc, m, g, s, p0, K);
      else
        dense_pass<TILE, RM, CN, false>(acc, m, g, s, p0, K);
    }

    Quad qd[NQ];
#pragma unroll
    for (int q = 0; q < NQ; ++q) qd[q] = quad_at(m, g, p0 + (q * S::TC + tc) * 4);
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      if (!qd[q].kin) continue;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float b = __ldg(qd[q].b + c);
#pragma unroll
        for (int i = 0; i < RM; ++i) acc[i][4 * q + c] = acc[i][4 * q + c] + b;
      }
    }

    if (!g.out) {
      __syncthreads();  // every read of this group's inputs is done
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (!qd[q].kin || qd[q].j + c >= qd[q].out) continue;
          float* y = s.buf + (size_t)(qd[q].dst + c) * m.xs + r0;
#pragma unroll
          for (int i = 0; i < RM; i += 4) {
            *reinterpret_cast<float4*>(y + i) =
                make_float4(fmaxf(acc[i][4 * q + c], 0.f), fmaxf(acc[i + 1][4 * q + c], 0.f),
                            fmaxf(acc[i + 2][4 * q + c], 0.f), fmaxf(acc[i + 3][4 * q + c], 0.f));
          }
        }
      }
    } else if (!emit_codes) {
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        if (!qd[q].kin) continue;
        const Head& H = m.heads[qd[q].head];
        float* lg = m.logits[qd[q].head];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (qd[q].j + c >= qd[q].out) continue;
#pragma unroll
          for (int i = 0; i < RM; ++i) {
            const int row = row0 + r0 + i;
            if (row < n) lg[(size_t)row * H.card_pad + qd[q].j + c] = acc[i][4 * q + c];
          }
        }
      }
    } else {
      // Each head whose columns meet this pass: fold the thread's columns
      // of it, reduce each row across threads, and merge with the best of
      // the head's earlier passes; where the head ends, that is its code.
      for (int mi = g.first; mi < g.first + g.count; ++mi) {
        const Member& M = m.members[mi];
        const int card = m.heads[M.head].card;
        const int end = M.col + ((card + 3) & ~3);
        if (end <= p0 || M.col >= p0 + S::PASS) continue;
        float bv[RM];
        int bi[RM];
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          bv[i] = -INFINITY;
          bi[i] = 0x7fffffff;
        }
        // A thread meets its columns in ascending order, so `after` is
        // better() here.
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int j = p0 + (q * S::TC + tc) * 4 + c - M.col;
            if (j < 0 || j >= card) continue;
#pragma unroll
            for (int i = 0; i < RM; ++i) {
              const bool t = after(acc[i][4 * q + c], bv[i], bi[i]);
              bv[i] = t ? acc[i][4 * q + c] : bv[i];
              bi[i] = t ? j : bi[i];
            }
          }
        }
        int row, ix;
        float v;
        if (reduce_rows<TILE, RM, CN>(bv, bi, s, r0, row, v, ix)) {
          if (M.col < p0 && better(run_v, run_i, v, ix)) {
            v = run_v;
            ix = run_i;
          }
          run_v = v;
          run_i = ix;
          if (end <= p0 + S::PASS) s.codes[row * m.n_heads + M.head] = ix;
        }
      }
    }
    __syncthreads();  // this pass's writes before the next reads
  }
}

// Whole-model forward on one tile of TILE rows whose digits are in s.dg.
template <int TILE, int RM, int CN>
__device__ void forward(const Model& m, const Smem& s, bool emit_codes, int row0, int n) {
  for (int gi = 0; gi < m.n_groups; ++gi)
    run_group<TILE, RM, CN>(m, m.groups[gi], s, emit_codes, row0, n);
  if (!emit_codes) {
    // Logit columns from the card up to card_pad are zeros.
    for (int h = 0; h < m.n_heads; ++h) {
      const Head& H = m.heads[h];
      const int padc = H.card_pad - H.card;
      for (int idx = threadIdx.x; idx < TILE * padc; idx += THREADS) {
        const int row = row0 + idx / padc;
        if (row < n) m.logits[h][(size_t)row * H.card_pad + H.card + idx % padc] = 0.f;
      }
    }
  }
}

template <int TILE, int RM, int CN>
__global__ void __launch_bounds__(THREADS, 1)
    fused_lookup_kernel(const __grid_constant__ Model m, const int* __restrict__ keys, int n,
                        const int* __restrict__ pos_ops, long long capacity,
                        const unsigned* __restrict__ words, int n_words, int with_exists,
                        const __grid_constant__ Preds preds, int* __restrict__ codes,
                        int* __restrict__ exists, int* __restrict__ match) {
  extern __shared__ __align__(16) float smem[];
  const Smem s = carve<TILE, RM, CN>(smem, m);
  const int row0 = blockIdx.x * TILE;
  for (int i = threadIdx.x; i < 2 * m.width; i += THREADS) s.ops[i] = pos_ops[i];
  for (int i = threadIdx.x; i < m.xs; i += THREADS) s.buf[(size_t)m.cap * m.xs + i] = 0.f;
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
  forward<TILE, RM, CN>(m, s, true, row0, n);
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

template <int TILE, int RM, int CN>
__global__ void __launch_bounds__(THREADS, 1)
    fused_mlp_kernel(const __grid_constant__ Model m, const int* __restrict__ digits, int n,
                     int emit_codes, int* __restrict__ codes) {
  extern __shared__ __align__(16) float smem[];
  const Smem s = carve<TILE, RM, CN>(smem, m);
  const int row0 = blockIdx.x * TILE;
  for (int i = threadIdx.x; i < m.xs; i += THREADS) s.buf[(size_t)m.cap * m.xs + i] = 0.f;
  for (int idx = threadIdx.x; idx < TILE * m.width; idx += THREADS) {
    const int r = idx / m.width;
    const int row = row0 + r;
    s.dg[idx] = row < n ? digits[(size_t)row0 * m.width + idx] : 0;
  }
  __syncthreads();
  forward<TILE, RM, CN>(m, s, emit_codes != 0, row0, n);
  if (emit_codes && threadIdx.x < TILE) {
    const int r = threadIdx.x;
    const int row = row0 + r;
    if (row < n) {
      for (int h = 0; h < m.n_heads; ++h)
        codes[(size_t)row * m.n_heads + h] = s.codes[r * m.n_heads + h];
    }
  }
}

// Fill the model from the descriptor arrays and check the plan against
// it.  Returns 0, or cudaErrorInvalidValue.
int fill_model(Model* m, const long long* w_ptrs, const long long* b_ptrs,
               const int* layer_info, int n_layers, const int* head_info, int n_heads,
               int width, int base, int base_pad, const int* plan_info, const int* groups,
               int n_groups, const int* members, int n_members, const long long* logit_ptrs) {
  const int bad = (int)cudaErrorInvalidValue;
  if (n_layers < 1 || n_layers > MAX_LAYERS || n_heads < 1 || n_heads > MAX_HEADS ||
      n_groups < 1 || n_groups > MAX_LAYERS || n_members != n_layers) {
    return bad;
  }
  const int rows = plan_info[0], slab = plan_info[3], xs = plan_info[4], cap = plan_info[5];
  if (xs < rows || xs % 4 != 0 || cap < 0 || slab < 0) return bad;
  for (int l = 0; l < n_layers; ++l) {
    Layer& L = m->layers[l];
    L.w = reinterpret_cast<const float*>(w_ptrs[l]);
    L.b = reinterpret_cast<const float*>(b_ptrs[l]);
    L.in_dim = layer_info[4 * l + 0];
    L.out_dim = layer_info[4 * l + 1];
    L.ld = layer_info[4 * l + 2];
    L.embed = layer_info[4 * l + 3];
    if (L.out_dim < 1 || L.ld < ((L.out_dim + 3) & ~3) || L.ld % 4 != 0) return bad;
  }
  for (int h = 0; h < n_heads; ++h) {
    Head& H = m->heads[h];
    H.first = head_info[4 * h + 0];
    H.count = head_info[4 * h + 1];
    H.card = head_info[4 * h + 2];
    H.card_pad = head_info[4 * h + 3];
    m->logits[h] = logit_ptrs ? reinterpret_cast<float*>(logit_ptrs[h]) : nullptr;
    if (H.card < 1 || H.card_pad < H.card) return bad;
  }
  int seen_layer[MAX_LAYERS] = {0};
  int seen_head[MAX_HEADS] = {0};
  for (int gi = 0; gi < n_groups; ++gi) {
    Group& G = m->groups[gi];
    G.first = groups[4 * gi + 0];
    G.count = groups[4 * gi + 1];
    G.cols = groups[4 * gi + 2];
    G.out = groups[4 * gi + 3];
    if (G.first < 0 || G.count < 1 || G.first + G.count > n_members) return bad;
    int col = 0;
    for (int i = G.first; i < G.first + G.count; ++i) {
      Member& M = m->members[i];
      M.layer = members[5 * i + 0];
      M.head = members[5 * i + 1];
      M.col = members[5 * i + 2];
      M.src = members[5 * i + 3];
      M.dst = members[5 * i + 4];
      if (M.layer < 0 || M.layer >= n_layers || seen_layer[M.layer]++ || M.col != col) return bad;
      const Layer& L = m->layers[M.layer];
      if (L.embed != m->layers[members[5 * G.first]].embed) return bad;
      if (L.embed ? M.src != -1 : (M.src < 0 || M.src + L.in_dim > cap)) return bad;
      if (G.out) {
        if (M.head < 0 || M.head >= n_heads || seen_head[M.head]++ || M.dst != -1) return bad;
        const Head& H = m->heads[M.head];
        if (M.layer != H.first + H.count - 1 || L.out_dim != H.card) return bad;
      } else if (M.dst < 0 || M.dst + L.out_dim > cap) {
        return bad;
      }
      col += (L.out_dim + 3) & ~3;
    }
    if (col != G.cols) return bad;
  }
  for (int h = 0; h < n_heads; ++h)
    if (!seen_head[h]) return bad;
  m->n_groups = n_groups;
  m->n_heads = n_heads;
  m->width = width;
  m->base = base;
  m->base_pad = base_pad;
  m->cap = cap;
  m->xs = xs;
  m->slab = slab;
  return 0;
}

// A hidden group of more than one pass writes while it still reads, so
// its outputs may not overlap its inputs.
int check_overlap(const Model& m, int pass) {
  for (int gi = 0; gi < m.n_groups; ++gi) {
    const Group& G = m.groups[gi];
    if (G.out || G.cols <= pass) continue;
    const int d0 = m.members[G.first].dst, d1 = d0 + G.cols;
    for (int i = G.first; i < G.first + G.count; ++i) {
      const Member& M = m.members[i];
      const int s1 = M.src + m.layers[M.layer].in_dim;
      if (M.src >= 0 && M.src < d1 && d0 < s1) return (int)cudaErrorInvalidValue;
    }
  }
  return 0;
}

template <int TILE, int RM, int CN>
int check_shape(const Model& m, int smem_bytes) {
  using S = Shape<TILE, RM, CN>;
  if ((size_t)smem_bytes != 4 * S::words(m.cap, m.xs, m.slab, m.width, m.n_heads) ||
      smem_bytes > SMEM_LIMIT || (m.slab == 0 && !S::FROM_L2)) {
    return (int)cudaErrorInvalidValue;
  }
  return check_overlap(m, S::PASS);
}

struct LookupArgs {
  const int* keys;
  int n;
  const int* ops;
  long long capacity;
  const unsigned* words;
  int n_words, with_exists;
  Preds preds;
  int *codes, *exists, *match;
};

// A kernel's dynamic shared memory limit is one attribute of an
// instantiation on a device.  It is set once for each, to SMEM_LIMIT
// (check_shape rejects any launch past it), never to one launch's size:
// threads that launch one instantiation at once with other sizes (a
// cluster's shards, whose models differ) would otherwise set it under each
// other's launches, and a launch past the size another thread just set
// fails with "invalid argument".
constexpr int MAX_DEVICES = 64;

template <typename Kernel>
int allow_smem_limit(Kernel kernel, std::once_flag (&once)[MAX_DEVICES],
                     int (&set_err)[MAX_DEVICES]) {
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err) return err;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  std::call_once(once[dev], [&] {
    set_err[dev] = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
  });
  return set_err[dev];
}

template <int TILE, int RM, int CN>
int launch_lookup(const Model& m, int smem_bytes, const LookupArgs& a, cudaStream_t st) {
  int err = check_shape<TILE, RM, CN>(m, smem_bytes);
  if (err) return err;
  static std::once_flag once[MAX_DEVICES];
  static int set_err[MAX_DEVICES];
  err = allow_smem_limit(fused_lookup_kernel<TILE, RM, CN>, once, set_err);
  if (err) return err;
  fused_lookup_kernel<TILE, RM, CN><<<(a.n + TILE - 1) / TILE, THREADS, smem_bytes, st>>>(
      m, a.keys, a.n, a.ops, a.capacity, a.words, a.n_words, a.with_exists, a.preds, a.codes,
      a.exists, a.match);
  return (int)cudaGetLastError();
}

template <int TILE, int RM, int CN>
int launch_mlp(const Model& m, int smem_bytes, const int* digits, int n, int emit_codes,
               int* codes, cudaStream_t st) {
  int err = check_shape<TILE, RM, CN>(m, smem_bytes);
  if (err) return err;
  static std::once_flag once[MAX_DEVICES];
  static int set_err[MAX_DEVICES];
  err = allow_smem_limit(fused_mlp_kernel<TILE, RM, CN>, once, set_err);
  if (err) return err;
  fused_mlp_kernel<TILE, RM, CN><<<(n + TILE - 1) / TILE, THREADS, smem_bytes, st>>>(
      m, digits, n, emit_codes, codes);
  return (int)cudaGetLastError();
}

// The instantiations: (rows, rm, cn) of TILES in fused_mlp.py.
int tile_index(const int* plan_info) {
  const int t[3][3] = {{128, 16, 8}, {32, 8, 4}, {8, 8, 4}};
  for (int i = 0; i < 3; ++i) {
    if (plan_info[0] == t[i][0] && plan_info[1] == t[i][1] && plan_info[2] == t[i][2]) return i;
  }
  return -1;
}

}  // namespace

extern "C" {

const char* repro_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

int repro_fused_lookup(const long long* w_ptrs, const long long* b_ptrs, const int* layer_info,
                       int n_layers, const int* head_info, int n_heads, int width, int base,
                       int base_pad, const int* plan_info, int smem_bytes, const int* groups,
                       int n_groups, const int* members, int n_members, const void* keys, int n,
                       const void* pos_ops, long long capacity, const void* words, int n_words,
                       int with_exists, const long long* pred_ptrs, const int* pred_tasks,
                       int n_preds, void* codes, void* exists, void* match, void* stream) {
  Model m;
  int err = fill_model(&m, w_ptrs, b_ptrs, layer_info, n_layers, head_info, n_heads, width, base,
                       base_pad, plan_info, groups, n_groups, members, n_members, nullptr);
  if (err) return err;
  if (n_preds > MAX_PREDS) return (int)cudaErrorInvalidValue;
  LookupArgs a;
  a.keys = static_cast<const int*>(keys);
  a.n = n;
  a.ops = static_cast<const int*>(pos_ops);
  a.capacity = capacity;
  a.words = static_cast<const unsigned*>(words);
  a.n_words = n_words;
  a.with_exists = with_exists;
  a.preds.n = n_preds;
  for (int j = 0; j < n_preds; ++j) {
    a.preds.tables[j] = reinterpret_cast<const int*>(pred_ptrs[j]);
    a.preds.tasks[j] = pred_tasks[j];
  }
  a.codes = static_cast<int*>(codes);
  a.exists = static_cast<int*>(exists);
  a.match = static_cast<int*>(match);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (tile_index(plan_info)) {
    case 0: return launch_lookup<128, 16, 8>(m, smem_bytes, a, st);
    case 1: return launch_lookup<32, 8, 4>(m, smem_bytes, a, st);
    case 2: return launch_lookup<8, 8, 4>(m, smem_bytes, a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

int repro_fused_mlp(const long long* w_ptrs, const long long* b_ptrs, const int* layer_info,
                    int n_layers, const int* head_info, int n_heads, int width, int base,
                    int base_pad, const int* plan_info, int smem_bytes, const int* groups,
                    int n_groups, const int* members, int n_members, const void* digits, int n,
                    int emit_codes, void* codes, const long long* logit_ptrs, void* stream) {
  Model m;
  int err = fill_model(&m, w_ptrs, b_ptrs, layer_info, n_layers, head_info, n_heads, width, base,
                       base_pad, plan_info, groups, n_groups, members, n_members,
                       emit_codes ? nullptr : logit_ptrs);
  if (err) return err;
  const auto* d = static_cast<const int*>(digits);
  auto* c = static_cast<int*>(codes);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (tile_index(plan_info)) {
    case 0: return launch_mlp<128, 16, 8>(m, smem_bytes, d, n, emit_codes, c, st);
    case 1: return launch_mlp<32, 8, 4>(m, smem_bytes, d, n, emit_codes, c, st);
    case 2: return launch_mlp<8, 8, 4>(m, smem_bytes, d, n, emit_codes, c, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
