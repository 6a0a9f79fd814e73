// K1: circle FFT butterflies over batched M31 columns.
//
// Replaces the JAX package's `_jit_lde` (parallel/accel.py), `_jit_ifft_t`
// and `_jit_fft`, which trace fft.ifft / fft.fft / fft_dup2.
//
// One launch per butterfly stage, one thread per butterfly pair, reading a
// (n_cols, 2^log_n) buffer and writing another (stages ping-pong between
// two buffers: a pair's outputs land where other pairs read).  The stage of
// block size m = 2^log_m pairs, inside each block,
//   inverse:  (j, m-1-j) -> (j, m/2+j):  e = (x+y)/2,  o = (x-y) * tw[j]
//   forward:  (j, m/2+j) -> (j, m-1-j):  x + tw[j]*o,  x - tw[j]*o
// with tw the stage's row of the cached twiddle table (1/(2y) or 1/(2x) for
// the inverse, y or x for the forward transform).  `lum_fft_embed` writes
// the zero-strided embedding of the LDE (or its duplicate form at blowup 1,
// whose first forward stage is then skipped).
//
// Bound on this card: device memory.  A stage reads and writes 8 bytes per
// element and does one multiply per pair, so the integer units idle; the
// twiddle row is read once per block and stays in L1/L2.  Keeping several
// stages in shared memory would cut the traffic; that is later work.

#include <cuda_runtime.h>

#include "m31.cuh"

namespace {

__global__ void fft_stage_kernel(const uint32_t* __restrict__ src, uint32_t* __restrict__ dst,
                                 const uint32_t* __restrict__ tw, long long n_pairs, int log_n,
                                 int log_m, int inverse) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_pairs) return;
  long long col = t >> (log_n - 1);
  long long k = t & ((1LL << (log_n - 1)) - 1);
  long long half = 1LL << (log_m - 1);
  long long base = (col << log_n) + ((k >> (log_m - 1)) << log_m);
  long long j = k & (half - 1);
  uint32_t w = tw[j];
  if (inverse) {
    uint32_t x = src[base + j];
    uint32_t y = src[base + 2 * half - 1 - j];
    dst[base + j] = lum::mul(lum::add(x, y), lum::INV2);
    dst[base + half + j] = lum::mul(lum::sub(x, y), w);
  } else {
    uint32_t e = src[base + j];
    uint32_t to = lum::mul(w, src[base + half + j]);
    dst[base + j] = lum::add(e, to);
    dst[base + 2 * half - 1 - j] = lum::sub(e, to);
  }
}

__global__ void fft_embed_kernel(const uint32_t* __restrict__ src, uint32_t* __restrict__ dst,
                                 long long n_out, int log_n_out, int log_blowup, int duplicate) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_out) return;
  long long col = t >> log_n_out;
  long long i = t & ((1LL << log_n_out) - 1);
  long long src_row = (col << (log_n_out - log_blowup)) + (i >> log_blowup);
  if (duplicate) {
    dst[t] = src[src_row];
  } else {
    dst[t] = (i & ((1LL << log_blowup) - 1)) == 0 ? src[src_row] : 0u;
  }
}

inline unsigned grid_for(long long n) { return (unsigned)((n + 255) / 256); }

}  // namespace

extern "C" int lum_fft_stage(const uint32_t* src, uint32_t* dst, const uint32_t* tw,
                             long long n_cols, int log_n, int log_m, int inverse, void* stream) {
  long long n_pairs = n_cols << (log_n - 1);
  if (n_pairs > 0) {
    fft_stage_kernel<<<grid_for(n_pairs), 256, 0, (cudaStream_t)stream>>>(src, dst, tw, n_pairs,
                                                                          log_n, log_m, inverse);
  }
  return (int)cudaGetLastError();
}

extern "C" int lum_fft_embed(const uint32_t* src, uint32_t* dst, long long n_cols, int log_n_out,
                             int log_blowup, int duplicate, void* stream) {
  long long n_out = n_cols << log_n_out;
  if (n_out > 0) {
    fft_embed_kernel<<<grid_for(n_out), 256, 0, (cudaStream_t)stream>>>(src, dst, n_out, log_n_out,
                                                                       log_blowup, duplicate);
  }
  return (int)cudaGetLastError();
}
