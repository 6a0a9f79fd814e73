// K4: the DEEP quotient of one (commit log, sample point) group.
//
// Replaces the JAX package's `_jit_quotient_group` (parallel/accel.py),
// which traces the per-group body of pcs/quotients.accumulate_quotients.
//
// One thread per domain row with coordinates (x, y):
//   L   = A*x - B*y + C                     (the line through z and conj z)
//   num = sum_j gamma_j * c_j(row) - acc_a*x - acc_c0
//   out = num * L^-1            (or out += ..., when `accumulate` is set,
//                                because two point groups share a log)
// The S sampled columns are M31 (gamma_j * c_j is 4 base multiplies) and
// are read through a device table of column pointers, so the columns are
// never stacked.  consts holds A, B, C, acc_a, acc_c0 as five QM31 rows.
//
// Bound on this card: the integer ALU -- one QM31 inverse per row (an M31
// Fermat chain of about 40 multiplies plus the tower) and 4 multiplies per
// column, against 4 bytes read per column and 16 bytes written.

#include <cuda_runtime.h>

#include "m31.cuh"

namespace {

__global__ void deep_quotient_kernel(const unsigned long long* __restrict__ col_ptrs,
                                     const uint32_t* __restrict__ gammas, int n_samples,
                                     const uint32_t* __restrict__ xs,
                                     const uint32_t* __restrict__ ys,
                                     const uint32_t* __restrict__ consts,
                                     uint32_t* __restrict__ out, long long n, int accumulate) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t x = xs[i], y = ys[i];
  lum::qm31 A = lum::qload(consts), B = lum::qload(consts + 4), C = lum::qload(consts + 8);
  lum::qm31 acc_a = lum::qload(consts + 12), acc_c0 = lum::qload(consts + 16);
  lum::qm31 den = lum::qadd(lum::qsub(lum::qmul_m31(A, x), lum::qmul_m31(B, y)), C);
  lum::qm31 num = {0, 0, 0, 0};
  for (int j = 0; j < n_samples; j++) {
    uint32_t c = ((const uint32_t*)col_ptrs[j])[i];
    num = lum::qadd(num, lum::qmul_m31(lum::qload(gammas + 4 * j), c));
  }
  num = lum::qsub(num, lum::qmul_m31(acc_a, x));
  num = lum::qsub(num, acc_c0);
  lum::qm31 q = lum::qmul(num, lum::qinv(den));
  if (accumulate) q = lum::qadd(lum::qload(out + 4 * i), q);
  lum::qstore(out + 4 * i, q);
}

}  // namespace

extern "C" int lum_deep_quotient(const unsigned long long* col_ptrs, const uint32_t* gammas,
                                 int n_samples, const uint32_t* xs, const uint32_t* ys,
                                 const uint32_t* consts, uint32_t* out, long long n,
                                 int accumulate, void* stream) {
  if (n > 0) {
    deep_quotient_kernel<<<(unsigned)((n + 127) / 128), 128, 0, (cudaStream_t)stream>>>(
        col_ptrs, gammas, n_samples, xs, ys, consts, out, n, accumulate);
  }
  return (int)cudaGetLastError();
}
