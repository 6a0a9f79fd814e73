// K4's work: the DEEP quotients of every (commit log, sample point) group of
// a prove, every log in one launch (csrc/quotient.cu).
//
// Compiles with g++ as well (define __host__ and __device__ empty and
// __forceinline__ inline): a block of one thread, whose sync does nothing,
// runs each CTA in order on the CPU; the tests hold it against the twin.
//
// A sample point z = (zx, zy) lies off the base field, and the line through
// z and its conjugate is L(x, y) = A x - B y + C with A, B and C in u * CM31
// (pcs/quotients.py), so L = u * d with the CM31 value
//   d(x, y) = dx x + dy y + d0,
// affine in the row's (x, y), and L^-1 = u^-1 d^-1.  The host folds u^-1
// into the group's gammas and its linear terms, so a group's quotient on a
// row is
//   q = (sum_j g_j c_j(x, y) + na x + nc) / d(x, y)
// with g_j = gamma_j u^-1, na = -acc_a u^-1, nc = -acc_c0 u^-1.  A log's
// output is the sum of its groups' quotients.  A thread owns R consecutive
// rows of one log and runs every group of that log on them: it keeps the
// groups' sum as one fraction N / D over a common CM31 denominator (D the
// product of the groups' d), then inverts the R rows' D through their M31
// norms with one Fermat chain (Montgomery's batch trick) and writes each
// row once.  A group whose d is 0 on a row adds 0 there, as the reference's
// inv(0) = 0 has it: its d is taken as 1 and its numerator as 0, so no zero
// norm reaches the batch.
//
// Every product is folded once into a 64-bit sum (fold_mac) and each sum is
// reduced once (reduce64); field sums are exact, so the result does not
// depend on the order of summation.
//
// Descriptor (int64 words, one upload per call):
//   [0] logs, [1] groups, [2] columns;
//   per log l at DQ_HEAD + l * DQ_LOG_WORDS: [0] log, [1] first group,
//     [2] groups, [3] first CTA, [4] CTAs, [5] first output row,
//     [6] xs, [7] ys (the domain's coordinate tables);
//   per group g at DQ_HEAD + logs * DQ_LOG_WORDS + g * DQ_GROUP_WORDS:
//     [0] columns S, [1] first column, [2..7] dx, dy, d0 (real, imaginary),
//     [8..11] na, [12..15] nc;
//   then one column address per column, groups in order; then the gammas
//   g_j, four uint32 words per column (two to an int64 word).
#pragma once

#include <stdint.h>

#include "m31.cuh"

namespace lum {

constexpr int DQ_HEAD = 3;
constexpr int DQ_LOG_WORDS = 8;
constexpr int DQ_GROUP_WORDS = 16;

// v[r] = base[row + r] for the rows below n (0 beyond): 16-byte loads where
// R allows and the address is aligned.
template <int R>
__host__ __device__ __forceinline__ void dq_load_rows(const uint32_t* base, long long row, long long n,
                                                      uint32_t v[R]) {
  if (R % 4 == 0 && row + R <= n && (reinterpret_cast<uintptr_t>(base + row) & 15) == 0) {
#pragma unroll
    for (int q = 0; q < R / 4; q++) {
      const u32x4 t = *reinterpret_cast<const u32x4*>(base + row + 4 * q);
#pragma unroll
      for (int e = 0; e < 4; e++) v[4 * q + e] = t.v[e];
    }
  } else {
#pragma unroll
    for (int r = 0; r < R; r++) v[r] = row + r < n ? base[row + r] : 0u;
  }
}

// acc += q * (e + f i), the QM31-by-CM31 product, folded.
__host__ __device__ __forceinline__ void dq_mac_cm(unsigned long long acc[4], const qm31& q, uint32_t e,
                                                   uint32_t f) {
  fold_mac(acc[0], q.a, e);
  fold_mac(acc[0], P - q.b, f);
  fold_mac(acc[1], q.a, f);
  fold_mac(acc[1], q.b, e);
  fold_mac(acc[2], q.c, e);
  fold_mac(acc[2], P - q.d, f);
  fold_mac(acc[3], q.c, f);
  fold_mac(acc[3], q.d, e);
}

// The rows of CTA `cta` (`b.threads()` threads, R rows each): every group
// of the CTA's log on them, into out (rows, 4).  `sptr` and `sgam` stage
// `chunk` columns' addresses and gammas at a time.
template <int R, class Block>
__device__ __forceinline__ void dq_cta(const Block& b, const long long* desc, long long cta, uint32_t* out,
                                       unsigned long long* sptr, u32x4* sgam, int chunk) {
  const int n_logs = (int)desc[0], n_groups = (int)desc[1];
  const long long* groups = desc + DQ_HEAD + (long long)n_logs * DQ_LOG_WORDS;
  const long long* ptrs = groups + (long long)n_groups * DQ_GROUP_WORDS;
  const uint32_t* gam = reinterpret_cast<const uint32_t*>(ptrs + desc[2]);
  const long long* lr = desc + DQ_HEAD;
  while (cta >= lr[3] + lr[4]) lr += DQ_LOG_WORDS;
  const long long n = 1LL << lr[0];
  const long long row = (cta - lr[3]) * b.threads() * R + (long long)b.tid() * R;
  uint32_t x[R], y[R];
  dq_load_rows<R>(reinterpret_cast<const uint32_t*>(lr[6]), row, n, x);
  dq_load_rows<R>(reinterpret_cast<const uint32_t*>(lr[7]), row, n, y);
  qm31 N[R];
  uint32_t Dr[R], Di[R];
#pragma unroll
  for (int r = 0; r < R; r++) {
    N[r] = {0, 0, 0, 0};
    Dr[r] = 1;
    Di[r] = 0;
  }
  for (long long gi = lr[1]; gi < lr[1] + lr[2]; gi++) {
    const long long* g = groups + gi * DQ_GROUP_WORDS;
    const long long S = g[0], first = g[1];
    unsigned long long s[R][4];
#pragma unroll
    for (int r = 0; r < R; r++) {
#pragma unroll
      for (int w = 0; w < 4; w++) {
        s[r][w] = (unsigned long long)g[12 + w];
        fold_mac(s[r][w], (uint32_t)g[8 + w], x[r]);
      }
    }
    for (long long c0 = 0; c0 < S; c0 += chunk) {
      const int m = (int)(S - c0 < chunk ? S - c0 : chunk);
      b.sync();  // the last chunk's columns are no longer read
      for (int k = b.tid(); k < m; k += b.threads()) {
        sptr[k] = (unsigned long long)ptrs[first + c0 + k];
        const uint32_t* q = gam + 4 * (first + c0 + k);
        sgam[k] = {{q[0], q[1], q[2], q[3]}};
      }
      b.sync();
      for (int k = 0; k < m; k++) {
        uint32_t v[R];
        dq_load_rows<R>(reinterpret_cast<const uint32_t*>(sptr[k]), row, n, v);
        const u32x4 gv = sgam[k];
#pragma unroll
        for (int r = 0; r < R; r++) {
#pragma unroll
          for (int w = 0; w < 4; w++) fold_mac(s[r][w], v[r], gv.v[w]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R; r++) {
      unsigned long long er = (unsigned long long)g[6], ei = (unsigned long long)g[7];
      fold_mac(er, (uint32_t)g[2], x[r]);
      fold_mac(er, (uint32_t)g[4], y[r]);
      fold_mac(ei, (uint32_t)g[3], x[r]);
      fold_mac(ei, (uint32_t)g[5], y[r]);
      uint32_t e = reduce64(er), f = reduce64(ei);
      qm31 num = {reduce64(s[r][0]), reduce64(s[r][1]), reduce64(s[r][2]), reduce64(s[r][3])};
      if (e == 0 && f == 0) {  // the line meets this row: the group adds 0
        e = 1;
        num = {0, 0, 0, 0};
      }
      if (gi == lr[1]) {
        N[r] = num;
        Dr[r] = e;
        Di[r] = f;
      } else {  // N / D + num / d = (N d + num D) / (D d)
        unsigned long long acc[4] = {0, 0, 0, 0};
        dq_mac_cm(acc, N[r], e, f);
        dq_mac_cm(acc, num, Dr[r], Di[r]);
        N[r] = {reduce64(acc[0]), reduce64(acc[1]), reduce64(acc[2]), reduce64(acc[3])};
        unsigned long long dr = 0, di = 0;
        fold_mac(dr, Dr[r], e);
        fold_mac(dr, P - Di[r], f);
        fold_mac(di, Dr[r], f);
        fold_mac(di, Di[r], e);
        Dr[r] = reduce64(dr);
        Di[r] = reduce64(di);
      }
    }
  }
  // D^-1 = conj(D) / |D|^2, the R norms inverted with one Fermat chain.
  uint32_t norm[R], pre[R];
#pragma unroll
  for (int r = 0; r < R; r++) {
    if (row + r >= n) {  // rows past the log's end: any nonzero norm
      Dr[r] = 1;
      Di[r] = 0;
    }
    unsigned long long t = 0;
    fold_mac(t, Dr[r], Dr[r]);
    fold_mac(t, Di[r], Di[r]);
    norm[r] = reduce64(t);
    if (r == 0) pre[0] = norm[0];
    else pre[r] = mul(pre[r - 1], norm[r]);
  }
  uint32_t inv_all = inv(pre[R - 1]);
#pragma unroll
  for (int r = R - 1; r >= 0; r--) {
    uint32_t ninv = inv_all;  // r == 0: what is left of the chain
    if (r > 0) {
      ninv = mul(inv_all, pre[r - 1]);
      inv_all = mul(inv_all, norm[r]);
    }
    if (row + r < n) {
      unsigned long long acc[4] = {0, 0, 0, 0};
      dq_mac_cm(acc, N[r], mul(Dr[r], ninv), mul(neg(Di[r]), ninv));
      u32x4 q = {{reduce64(acc[0]), reduce64(acc[1]), reduce64(acc[2]), reduce64(acc[3])}};
      *reinterpret_cast<u32x4*>(out + 4 * (lr[5] + row + r)) = q;
    }
  }
}

}  // namespace lum
