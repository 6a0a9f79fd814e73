// K3: one FRI fold of a QM31 evaluation, circle-to-line or line-to-line.
//
// Replaces the JAX package's `_jit_fold_circle` and `_jit_fold_line`
// (parallel/accel.py), which trace pcs/fri.fold_circle_to_line and
// fri.fold_line.
//
// One thread per output row i of n: with v0 = src[i] and v1 = src[2n-1-i]
// (the palindromic pair of the natural row order),
//   out[i] = (v0 + v1)/2 + alpha * (v0 - v1) * tw[i]        (QM31)
// where tw is 1/(2y) of the circle domain (circle fold) or 1/(2x) of the
// line domain (line fold).  With a `mix` input, out[i] += beta2 * mix[i]:
// the next smaller FRI input joins the chain scaled by the square of the
// fold challenge.
//
// lum_fri_fold_chain is the same fold with its challenge read from device
// memory: the alpha K8 drew into the FRI record (channel.cu) and the fold's
// index t within its committed layer; each thread squares its way to
// beta = alpha^(2^t) (t <= 8) and mixes with beta^2, so the chain needs no
// challenge on the host.
//
// Bound on this card: device memory -- 32 bytes read (plus 16 of mix) and
// 16 written per row against about 20 multiplies.

#include <cuda_runtime.h>

#include "m31.cuh"

namespace {

__global__ void fri_fold_kernel(const uint32_t* __restrict__ src, uint32_t* __restrict__ out,
                                const uint32_t* __restrict__ tw, const uint32_t* __restrict__ mix,
                                lum::qm31 alpha, lum::qm31 beta2, long long n) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  lum::qm31 v0 = lum::qload(src + 4 * i);
  lum::qm31 v1 = lum::qload(src + 4 * (2 * n - 1 - i));
  lum::qm31 e = lum::qmul_m31(lum::qadd(v0, v1), lum::INV2);
  lum::qm31 o = lum::qmul_m31(lum::qsub(v0, v1), tw[i]);
  lum::qm31 r = lum::qadd(e, lum::qmul(alpha, o));
  if (mix) r = lum::qadd(r, lum::qmul(beta2, lum::qload(mix + 4 * i)));
  lum::qstore(out + 4 * i, r);
}

__global__ void fri_fold_chain_kernel(const uint32_t* __restrict__ src, uint32_t* __restrict__ out,
                                      const uint32_t* __restrict__ tw, const uint32_t* __restrict__ mix,
                                      const uint32_t* __restrict__ alpha, int t, long long n) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  lum::qm31 beta = lum::qload(alpha);
  for (int s = 0; s < t; s++) beta = lum::qmul(beta, beta);
  lum::qm31 v0 = lum::qload(src + 4 * i);
  lum::qm31 v1 = lum::qload(src + 4 * (2 * n - 1 - i));
  lum::qm31 e = lum::qmul_m31(lum::qadd(v0, v1), lum::INV2);
  lum::qm31 o = lum::qmul_m31(lum::qsub(v0, v1), tw[i]);
  lum::qm31 r = lum::qadd(e, lum::qmul(beta, o));
  if (mix) r = lum::qadd(r, lum::qmul(lum::qmul(beta, beta), lum::qload(mix + 4 * i)));
  lum::qstore(out + 4 * i, r);
}

}  // namespace

extern "C" int lum_fri_fold(const uint32_t* src, uint32_t* out, const uint32_t* tw,
                            const uint32_t* mix, uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                            uint32_t b0, uint32_t b1, uint32_t b2, uint32_t b3, long long n,
                            void* stream) {
  if (n > 0) {
    lum::qm31 alpha = {a0, a1, a2, a3};
    lum::qm31 beta2 = {b0, b1, b2, b3};
    fri_fold_kernel<<<(unsigned)((n + 255) / 256), 256, 0, (cudaStream_t)stream>>>(
        src, out, tw, mix, alpha, beta2, n);
  }
  return (int)cudaGetLastError();
}

extern "C" int lum_fri_fold_chain(const uint32_t* src, uint32_t* out, const uint32_t* tw,
                                  const uint32_t* mix, const uint32_t* alpha, int t, long long n,
                                  void* stream) {
  if (n > 0) {
    fri_fold_chain_kernel<<<(unsigned)((n + 255) / 256), 256, 0, (cudaStream_t)stream>>>(
        src, out, tw, mix, alpha, t, n);
  }
  return (int)cudaGetLastError();
}
