// Existence-bitvector test for Hopper (sm_90a): Algorithm 1 line 5.
//
// bitvector_kernel replaces src/repro/kernels/bitvector.py :: _kernel,
// launched by bitvector_call (K3).  For each int32 key k it writes
// (words[k >> 5] >> (k & 31)) & 1 as one int32.
//
// Domain rule: a key outside [0, 32 * n_words) gets 0 and reads no memory.
// That matches the host BitVector.test and the existence test inside the
// fused lookup kernel (K1).  The Pallas kernel differs there: its
// jnp.take fills out-of-range word reads with 0xFFFFFFFF, so such keys
// read as present.  The port does not copy that.
//
// What bounds it on this card: it does no arithmetic worth counting and
// moves 8 bytes per key (4 in, 4 out) plus the words once, so it is bound
// by bytes.  At the TPC-H SF1 orders table the words are 1.5 MB, far
// below the 50 MB L2, so the random word reads hit L2 after their first
// touch; the key stream and the output are read and written coalesced.
// This simple design is one thread per key in a grid-stride loop, with
// each word read through the read-only path (__ldg) and no shared
// memory.
//
// Plain C interface, loaded with ctypes (repro_torch/kernels/bitvector.py).
// The entry returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 132 * 16;  // 16 blocks per SM; the loop covers the rest

__global__ void __launch_bounds__(THREADS)
    bitvector_kernel(const int* __restrict__ keys, long long n,
                     const unsigned* __restrict__ words, long long n_words,
                     int* __restrict__ out) {
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < n; i += stride) {
    const int k = keys[i];
    int bit = 0;
    if (k >= 0 && (long long)(k >> 5) < n_words) {
      bit = (int)((__ldg(words + (k >> 5)) >> (k & 31)) & 1u);
    }
    out[i] = bit;
  }
}

}  // namespace

extern "C" {

const char* repro_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

int repro_bitvector_test(const void* keys, long long n, const void* words, long long n_words,
                         void* out, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  long long blocks = (n + THREADS - 1) / THREADS;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  bitvector_kernel<<<(unsigned)blocks, THREADS, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(keys), n, static_cast<const unsigned*>(words), n_words,
      static_cast<int*>(out));
  return (int)cudaGetLastError();
}

}  // extern "C"
