// K7: many M31 coefficient columns of length N = 2^L at one QM31 point --
// the OODS values, (C, N) -> (C, 4).
//
// Replaces the JAX package's `_jit_eval_at_point` (parallel/accel.py).
//
// The value of column c is sum_j c_j * b_j with basis entry
//   b_j = prod over the set bits i of j of chain[L - 1 - i],
// chain = [y, x, pi(x), ..., pi^(L-2)(x)] of the point (fft.twiddle_chain),
// passed by value.  Pass 1 runs one block per (chunk of 2^11 rows, group of
// columns): the block builds its chunk's basis entries in shared memory by
// doubling from the chunk's high-bit factor (one QM31 product per entry),
// then for each of its columns every thread keeps four uint64 sums of
// reduced products (each below 2^31) over its rows, reduced by warp
// shuffles and shared memory into one partial (4 words, mod P) per
// (column, chunk).  Pass 2 adds each column's chunk partials in chunk order,
// so the result is the same on every run.
//
// Bound on this card: device memory for wide groups (4 bytes per
// coefficient, 4 M31 products per coefficient), the integer ALU for the
// basis (one QM31 product per row and chunk, shared by the block's
// columns).

#include <cuda_runtime.h>

#include "m31.cuh"

constexpr int OODS_MAX_LOG = 32;
constexpr int OODS_MAX_COLS = 256;

// Passed by value (the kernel parameter space holds it); mirrored by
// kernels.OodsArgs.  Outside the anonymous namespace: the C entry point
// takes it, and must keep external linkage.
struct OodsArgs {
  unsigned long long cols[OODS_MAX_COLS];  // column pointers (uint32 rows)
  uint32_t chain[OODS_MAX_LOG][4];
  int n_cols;
  int log_n;
};

namespace {

constexpr int CHUNK_LOG = 11;
constexpr int THREADS = 256;
constexpr int COLS_PER_BLOCK = 16;

__global__ void oods_partial_kernel(const __grid_constant__ OodsArgs a, uint32_t* __restrict__ partial) {
  __shared__ uint32_t basis[(1 << CHUNK_LOG) * 4];
  __shared__ unsigned long long red[THREADS / 32][4];
  const int chunk_log = min(a.log_n, CHUNK_LOG);
  const int chunk = 1 << chunk_log;
  const int n_chunks = 1 << (a.log_n - chunk_log);
  const long long base = (long long)blockIdx.x << chunk_log;
  if (threadIdx.x == 0) {
    lum::qm31 h = {1, 0, 0, 0};
    for (int i = chunk_log; i < a.log_n; i++) {
      if ((base >> i) & 1) h = lum::qmul(h, lum::qload(a.chain[a.log_n - 1 - i]));
    }
    lum::qstore(basis, h);
  }
  __syncthreads();
  for (int i = 0; i < chunk_log; i++) {
    const int half = 1 << i;
    const lum::qm31 t = lum::qload(a.chain[a.log_n - 1 - i]);
    for (int k = threadIdx.x; k < half; k += blockDim.x) {
      lum::qstore(basis + 4 * (half + k), lum::qmul(lum::qload(basis + 4 * k), t));
    }
    __syncthreads();
  }
  const int c0 = blockIdx.y * COLS_PER_BLOCK;
  const int c1 = min(a.n_cols, c0 + COLS_PER_BLOCK);
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  for (int c = c0; c < c1; c++) {
    const uint32_t* col = (const uint32_t*)a.cols[c] + base;
    unsigned long long s0 = 0, s1 = 0, s2 = 0, s3 = 0;  // 2^11 products below 2^31 each
    for (int k = threadIdx.x; k < chunk; k += blockDim.x) {
      const uint32_t x = col[k];
      const uint32_t* bk = basis + 4 * k;
      s0 += lum::mul(x, bk[0]);
      s1 += lum::mul(x, bk[1]);
      s2 += lum::mul(x, bk[2]);
      s3 += lum::mul(x, bk[3]);
    }
    for (int o = 16; o > 0; o >>= 1) {
      s0 += __shfl_down_sync(0xffffffffu, s0, o);
      s1 += __shfl_down_sync(0xffffffffu, s1, o);
      s2 += __shfl_down_sync(0xffffffffu, s2, o);
      s3 += __shfl_down_sync(0xffffffffu, s3, o);
    }
    if (lane == 0) {
      red[w][0] = s0;
      red[w][1] = s1;
      red[w][2] = s2;
      red[w][3] = s3;
    }
    __syncthreads();
    if (threadIdx.x < 4) {
      unsigned long long t = 0;
      for (int j = 0; j < THREADS / 32; j++) t += red[j][threadIdx.x];
      partial[((long long)c * n_chunks + blockIdx.x) * 4 + threadIdx.x] = (uint32_t)(t % lum::P);
    }
    __syncthreads();
  }
}

// out[c][k] = sum over chunks of partial[c][chunk][k], in chunk order.
__global__ void oods_combine_kernel(const uint32_t* __restrict__ partial, int n_cols, int n_chunks,
                                    uint32_t* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= 4 * n_cols) return;
  const int c = i >> 2, k = i & 3;
  unsigned long long t = 0;  // at most 2^21 partials below 2^31
  for (int j = 0; j < n_chunks; j++) t += partial[((long long)c * n_chunks + j) * 4 + k];
  out[i] = (uint32_t)(t % lum::P);
}

}  // namespace

// Checked against kernels.py when the library loads.
extern "C" long long lum_oods_args_size() { return (long long)sizeof(OodsArgs); }
extern "C" long long lum_oods_chunk_log() { return CHUNK_LOG; }

// `partial` is scratch of n_cols * max(1, 2^(log_n - 11)) * 4 words.
extern "C" int lum_oods_eval(const OodsArgs* args, uint32_t* partial, uint32_t* out, void* stream) {
  if (args->n_cols > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    const int chunk_log = args->log_n < CHUNK_LOG ? args->log_n : CHUNK_LOG;
    const int n_chunks = 1 << (args->log_n - chunk_log);
    dim3 grid(n_chunks, (args->n_cols + COLS_PER_BLOCK - 1) / COLS_PER_BLOCK);
    oods_partial_kernel<<<grid, THREADS, 0, s>>>(*args, partial);
    oods_combine_kernel<<<(4 * args->n_cols + 127) / 128, 128, 0, s>>>(partial, args->n_cols, n_chunks, out);
  }
  return (int)cudaGetLastError();
}
