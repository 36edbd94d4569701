// Existence-bitvector test for Hopper (sm_90a): Algorithm 1 line 5.
//
// bitvector_kernel replaces src/repro/kernels/bitvector.py :: _kernel,
// launched by bitvector_call (K3).  For each key k it writes
// (words[k >> 5] >> (k & 31)) & 1, as an int32 or as a 1-byte bool.
//
// Domain rule, applied to the key's full width: a key reads as present
// only if 0 <= k <= 2^31 - 1 and k >> 5 < n_words; any other key gets 0
// and reads no memory.  That matches the host BitVector.test inside the
// word domain and the existence test inside the fused lookup kernel
// (K1), and a key such as 2^32 + 5 reads as absent instead of wrapping
// round to another key's bit.  The Pallas kernel differs outside the
// domain: its jnp.take fills out-of-range word reads with 0xFFFFFFFF, so
// such keys read as present.  The port does not copy that.
//
// Instantiations: int32 keys -> int32 bits (the reference's contract,
// bitvector_call), and int32 or int64 keys -> bool (the public
// bitvector_test, one launch on the caller's own keys, with no widen,
// mask, pad, slice or cast around it).
//
// What bounds it on this card: bytes and memory latency.  There is no
// arithmetic to speak of; each key is read once (4 or 8 bytes), each
// result written once (4 or 1), and each word a key touches read once.
// The word reads are a data-dependent gather of 4-byte words: at the
// TPC-H SF1 orders table the words are 1.5 MB, and 12.5 MB at a 10^8-slot
// domain, both far below the 50 MB L2.  So the design works on latency
// and bytes:
//   * each thread takes four keys in 16-byte loads (one of int32 keys,
//     two of int64), issues its four word loads before it uses any of
//     them (four independent L2 or DRAM reads in flight instead of one
//     dependent chain), and stores its four results at once: 16 bytes
//     for int32 results, 4 (or twice 2) bytes for bools;
//   * the lanes of a warp take consecutive 16-byte vectors, so each load
//     or store instruction covers contiguous memory (512 bytes of keys),
//     and on sorted keys each gather instruction touches one or two
//     words' lines.  Giving a lane more than one consecutive vector
//     (8 or 16 consecutive keys a thread) strides a warp's accesses by 32
//     or 64 bytes, and was slower on the card than the one-key-a-thread
//     kernel that this one replaced;
//   * a scalar head covers the keys before the first 16-byte boundary of
//     a misaligned view, and a scalar tail the keys after the last whole
//     warp's tile (at most 127); results go one at a time where the
//     output is not aligned with the keys;
//   * keys and results stream with evict-first loads and stores
//     (__ldcs/__stcs), words go through the read-only path (__ldg), so
//     the word array stays in L2 for the whole call;
//   * the grid is at most one wave (SM count times resident blocks per
//     SM, read once; a failed query is the call's error), with a
//     grid-stride loop over the rest; a small batch takes only the
//     blocks it fills.
// No TMA, wgmma or warp ballot: there is no matrix product, a TMA tile
// cannot serve a data-dependent 4-byte gather, and a ballot packs bits
// where the contract gives one value per key.
//
// Plain C interface, loaded with ctypes (repro_torch/kernels/bitvector.py).
// The entry returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int THREADS = 256;
constexpr int ITEMS = 4;  // keys a thread per trip

// A lane's four keys: KV 16-byte vectors of KPI keys each, lane-interleaved
// across the warp (vector j of a lane sits 32 vectors after vector j - 1).
template <typename K>
struct KeyShape {
  static constexpr int KPI = 16 / (int)sizeof(K);
  static constexpr int KV = ITEMS / KPI;
  static constexpr int TILE = 32 * ITEMS;  // keys a warp per trip
};

// The store of one vector's KPI results, as one access.
template <int BYTES>
struct Store;
template <>
struct Store<16> {
  using T = int4;
};
template <>
struct Store<4> {
  using T = unsigned;
};
template <>
struct Store<2> {
  using T = unsigned short;
};

template <typename K>
__device__ __forceinline__ bool in_domain(K k, long long n_words) {
  return k >= 0 && (long long)k <= 0x7fffffffLL && ((long long)k >> 5) < n_words;
}

template <typename K>
__device__ __forceinline__ unsigned word_of(K k, const unsigned* __restrict__ words,
                                            long long n_words) {
  return in_domain(k, n_words) ? __ldg(words + ((long long)k >> 5)) : 0u;
}

template <typename K>
__device__ __forceinline__ int bit_of(unsigned w, K k) {
  return (int)((w >> ((unsigned)k & 31u)) & 1u);
}

// keys[head] is 16-byte aligned; whole warp tiles cover
// [head, body_end); the head and the tail go one key a thread.
// vec_out: out + head is aligned for one vector's results.
template <typename K, typename R>
__global__ void __launch_bounds__(THREADS)
    bitvector_kernel(const K* __restrict__ keys, long long n, int head,
                     const unsigned* __restrict__ words, long long n_words,
                     R* __restrict__ out, bool vec_out) {
  using S = KeyShape<K>;
  using ST = typename Store<S::KPI * (int)sizeof(R)>::T;
  const long long tid = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long stride = (long long)gridDim.x * THREADS;
  const long long tiles = (n - head) / S::TILE;
  const long long body_end = head + tiles * S::TILE;

  for (long long i = tid; i < head + (n - body_end); i += stride) {
    const long long at = i < head ? i : body_end + (i - head);
    const K k = __ldcs(keys + at);
    out[at] = (R)bit_of(word_of(k, words, n_words), k);
  }

  const int4* src = reinterpret_cast<const int4*>(keys + head);
  for (long long u = tid; u < tiles * 32; u += stride) {
    const long long v0 = (u >> 5) * (32 * S::KV) + (u & 31);  // the lane's first vector
    union {
      int4 v;
      K k[S::KPI];
    } q[S::KV];
#pragma unroll
    for (int j = 0; j < S::KV; ++j) q[j].v = __ldcs(src + v0 + 32 * j);
    unsigned w[S::KV][S::KPI];
#pragma unroll
    for (int j = 0; j < S::KV; ++j)
#pragma unroll
      for (int c = 0; c < S::KPI; ++c) w[j][c] = word_of(q[j].k[c], words, n_words);
#pragma unroll
    for (int j = 0; j < S::KV; ++j) {
      union {
        ST v;
        R r[S::KPI];
      } res;
#pragma unroll
      for (int c = 0; c < S::KPI; ++c) res.r[c] = (R)bit_of(w[j][c], q[j].k[c]);
      const long long at = head + (v0 + 32 * j) * S::KPI;
      if (vec_out) {
        __stcs(reinterpret_cast<ST*>(out + at), res.v);
      } else {
#pragma unroll
        for (int c = 0; c < S::KPI; ++c) out[at + c] = res.r[c];
      }
    }
  }
}

template <typename K, typename R>
int launch(const void* keys_v, long long n, const void* words, long long n_words, void* out_v,
           cudaStream_t stream) {
  // One wave: the SM count times the resident blocks per SM, read once per
  // instantiation (the port runs on one card).  A failed query is the call's error.
  static std::atomic<long long> wave{0};
  if (wave.load(std::memory_order_relaxed) == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, bitvector_kernel<K, R>, THREADS,
                                                        0);
    if (e != cudaSuccess) return (int)e;
    wave.store((long long)sms * per_sm, std::memory_order_relaxed);
  }
  using S = KeyShape<K>;
  const K* keys = static_cast<const K*>(keys_v);
  R* out = static_cast<R*>(out_v);
  long long head = (long long)((16u - ((uintptr_t)keys & 15u)) & 15u) / (long long)sizeof(K);
  if (head > n) head = n;
  const long long tiles = (n - head) / S::TILE;
  const long long scalar = n - tiles * S::TILE;  // head and tail: fewer than 4 + TILE
  const uintptr_t store_bytes = S::KPI * sizeof(R);
  const bool vec_out = ((uintptr_t)(out + head) % store_bytes) == 0;
  const long long threads = tiles * 32 > scalar ? tiles * 32 : scalar;
  long long blocks = (threads + THREADS - 1) / THREADS;
  const long long wave_blocks = wave.load(std::memory_order_relaxed);
  if (blocks > wave_blocks) blocks = wave_blocks;
  bitvector_kernel<K, R><<<(unsigned)blocks, THREADS, 0, stream>>>(
      keys, n, (int)head, static_cast<const unsigned*>(words), n_words, out, vec_out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* repro_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// key_bytes: 4 (int32) or 8 (int64); out_bytes: 4 (int32 0/1) or 1 (bool).
int repro_bitvector_test(const void* keys, int key_bytes, long long n, const void* words,
                         long long n_words, void* out, int out_bytes, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (key_bytes == 4 && out_bytes == 4) return launch<int, int>(keys, n, words, n_words, out, s);
  if (key_bytes == 4 && out_bytes == 1)
    return launch<int, unsigned char>(keys, n, words, n_words, out, s);
  if (key_bytes == 8 && out_bytes == 1)
    return launch<long long, unsigned char>(keys, n, words, n_words, out, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
