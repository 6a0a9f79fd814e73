// K3's per-row work (csrc/fri.cu): one output row of a committed FRI layer,
// every fold of the layer in registers.  The functions are __host__
// __device__, so the header builds with g++ too (tests/test_torch_fri_layer.py).
//
// A layer at line log L with F folds reads `src` (2^L QM31 rows) and writes
// the next layer (n = 2^(L-F) rows).  Level t holds N_t = n << (F - t)
// rows; fold t maps level t to level t + 1 over the palindromic pairs
// (j, N_t - 1 - j):
//   w[j] = (v[j] + v[N_t-1-j])/2 + beta_t (v[j] - v[N_t-1-j]) tw_t[j]
// with beta_t = alpha^(2^(t0 + t)) and tw_t the 1/(2x) line twiddles of
// the layer's stage t (pcs/fri.fold_line); where the FRI input of circle
// log L - t exists, it joins as
//   w[j] += beta_t^2 ((m[j] + m[N_t-1-j])/2 + alpha0 (m[j] - m[N_t-1-j]) ctw[j])
// its circle fold (1/(2y) twiddles ctw of its domain, challenge alpha0),
// computed here, so no input's line evaluation is ever stored.  The
// largest input's circle fold is a layer of one fold with ctw as tw_0 and
// alpha0 as alpha.
//
// Output row i depends on 2^F rows of src: position i at level F, and at
// level t the positions p and N_t - 1 - p of each position p at level t+1.
// For F = 2 over 4m rows these are i, 4m-1-i, 2m-1-i and 2m+i: two
// ascending and two descending streams, each coalesced across a warp.
#pragma once

#include <stdint.h>

#include "m31.cuh"

namespace lum {

constexpr int FRI_MAX_FOLDS = 4;  // the rows of a layer's folds are held in registers

// A layer's launch, passed by value (mirrored by kernels.FriLayer).
struct FriLayer {
  uint64_t src;                   // (2^L, 4) rows
  uint64_t out;                   // (n, 4) rows
  uint64_t alpha;                 // 4 words: beta_0 = alpha^(2^t0)
  uint64_t alpha0;                // 4 words: the joining inputs' circle-fold challenge (0: none join)
  uint64_t tw[FRI_MAX_FOLDS];     // fold t's twiddles, N_t / 2 words
  uint64_t mix[FRI_MAX_FOLDS];    // the input joining at fold t (N_t rows), or 0
  uint64_t mix_tw[FRI_MAX_FOLDS]; // its circle twiddles, N_t / 2 words
  long long n;                    // rows written
  int folds;                      // F, 1..FRI_MAX_FOLDS
  int t0;
};

// 16-byte rows; on the card through the read-only path.
__host__ __device__ __forceinline__ qm31 fri_load(uint64_t base, long long i) {
#ifdef __CUDA_ARCH__
  const uint4 v = __ldg(reinterpret_cast<const uint4*>(base) + i);
  return {v.x, v.y, v.z, v.w};
#else
  return qload(reinterpret_cast<const uint32_t*>(base) + 4 * i);
#endif
}

__host__ __device__ __forceinline__ uint32_t fri_twiddle(uint64_t base, long long i) {
#ifdef __CUDA_ARCH__
  return __ldg(reinterpret_cast<const uint32_t*>(base) + i);
#else
  return reinterpret_cast<const uint32_t*>(base)[i];
#endif
}

__host__ __device__ __forceinline__ void fri_store(uint64_t base, long long i, qm31 x) {
#ifdef __CUDA_ARCH__
  reinterpret_cast<uint4*>(base)[i] = make_uint4(x.a, x.b, x.c, x.d);
#else
  qstore(reinterpret_cast<uint32_t*>(base) + 4 * i, x);
#endif
}

// (v0 + v1)/2 + c (v0 - v1) tw.
__host__ __device__ __forceinline__ qm31 fold_pair(qm31 v0, qm31 v1, uint32_t tw, qm31 c) {
  return qadd(qmul_m31(qadd(v0, v1), INV2), qmul(c, qmul_m31(qsub(v0, v1), tw)));
}

template <int F>
__host__ __device__ __forceinline__ void fri_layer_row(const FriLayer& a, long long i) {
  constexpr int R = 1 << F;
  // p[j << t] is the row j < 2^(F-t) of level t that row i reads: the pair
  // of row q of level t + 1 is p[2k << t] = q and p[(2k+1) << t] = N_t-1-q.
  long long p[R];
  p[0] = i;
#pragma unroll
  for (int t = F - 1; t >= 0; t--) {
    const long long N = a.n << (F - t);
#pragma unroll
    for (int k = 0; k < (1 << (F - t - 1)); k++) p[(2 * k + 1) << t] = N - 1 - p[(2 * k) << t];
  }
  qm31 v[R];
#pragma unroll
  for (int j = 0; j < R; j++) v[j] = fri_load(a.src, p[j]);
  qm31 beta = qload(reinterpret_cast<const uint32_t*>(a.alpha));
  for (int s = 0; s < a.t0; s++) beta = qmul(beta, beta);
  const qm31 alpha0 = a.alpha0 ? qload(reinterpret_cast<const uint32_t*>(a.alpha0)) : qm31{0, 0, 0, 0};
#pragma unroll
  for (int t = 0; t < F; t++) {
    const qm31 beta2 = qmul(beta, beta);
    const long long N = a.n << (F - t);
#pragma unroll
    for (int k = 0; k < (1 << (F - t - 1)); k++) {  // in place: v[k] from v[2k], v[2k+1]
      const long long q = p[k << (t + 1)];
      qm31 r = fold_pair(v[2 * k], v[2 * k + 1], fri_twiddle(a.tw[t], q), beta);
      if (a.mix[t]) {
        const qm31 m = fold_pair(fri_load(a.mix[t], q), fri_load(a.mix[t], N - 1 - q), fri_twiddle(a.mix_tw[t], q),
                                 alpha0);
        r = qadd(r, qmul(beta2, m));
      }
      v[k] = r;
    }
    beta = beta2;
  }
  fri_store(a.out, i, v[0]);
}

}  // namespace lum
