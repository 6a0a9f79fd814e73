// K7's work: the OODS values of every (point, size) group of a prove --
// M31 coefficient columns of length N = 2^L at a QM31 point, (C, N) ->
// (C, 4) per group -- on a factored basis (csrc/oods.cu).
//
// Compiles with g++ as well (define __host__ and __device__ empty and
// __forceinline__ inline): a block of one thread in lane groups of one,
// whose sync does nothing and whose sums are the identity, runs the same
// code in order on the CPU; the tests hold it against the plain twin.
//
// The value of column c is sum_j c_j * b_j with basis entry
//   b_j = prod over the set bits i of j of chain[L - 1 - i],
// chain = [y, x, pi(x), ..., pi^(L-2)(x)] of the point (fft.twiddle_chain).
// Split j = (h, k), k its low c bits, c = min(L, the plan's chunk log,
// 11 on the card): b_j = B_lo[k] * B_hi[h].  A chunk h of a column gives the partial
//   (sum_k c_(h 2^c + k) B_lo[k]) * B_hi[h]:
// 4 M31 products per coefficient, one QM31 product per chunk.  B_lo (2^c
// entries) is the same for every chunk of a group; B_hi[h] = T1[h mod 2^a]
// * T2[h >> a] from two tables of 2^a and 2^(L-c-a) entries.  A CTA builds
// the three tables by doubling in shared memory when it starts on a group
// and keeps them for every unit of that group it takes.  The sums are exact
// in the field, so the value does not depend on the order of summation.
//
// Descriptor (int64 words, one upload per call):
//   [0] groups G, [1] units M (one per (column, chunk)), [2] output rows;
//   per group g, at OODS_HEAD + g * OODS_GROUP_WORDS: [0] L, [1] c, [2] a,
//     [3] columns, [4] first output row, [5] first unit, [6 + 4m ...]
//     chain[m];
//   then one column address per output row, groups in order.
// Unit first + column * 2^(L-c) + chunk of a group writes partial[unit]; a
// row's value is the sum of its partials, in chunk order
// (oods_combine_row).
#pragma once

#include <stdint.h>

#include "m31.cuh"

namespace lum {

constexpr int OODS_MAX_LOG = 32;
constexpr int OODS_HEAD = 3;
constexpr int OODS_GROUP_WORDS = 6 + 4 * OODS_MAX_LOG;

struct OodsGroup {
  int L, c, a, n_cols;
  long long row0, part0;
  const long long* chain;
};

__host__ __device__ __forceinline__ OodsGroup oods_group(const long long* desc, int g) {
  const long long* r = desc + OODS_HEAD + (long long)g * OODS_GROUP_WORDS;
  return {(int)r[0], (int)r[1], (int)r[2], (int)r[3], r[4], r[5], r + 6};
}

// Shared memory (words) of a CTA working on a group: B_lo (structure of
// arrays, 4 x 2^c words), T1 and T2 (4 words an entry).
__host__ __device__ __forceinline__ long long oods_smem_words(int L, int c, int a) {
  return (4LL << c) + (4LL << a) + (4LL << (L - c - a));
}

__host__ __device__ __forceinline__ qm31 oods_factor(const OodsGroup& g, int bit) {
  const long long* q = g.chain + 4 * (g.L - 1 - bit);
  return {(uint32_t)q[0], (uint32_t)q[1], (uint32_t)q[2], (uint32_t)q[3]};
}

// The 2^n products of the factors of bits first .. first + n - 1 (entry
// e: the product over the set bits i of e of factor first + i), by
// doubling.  `stride` words apart for the coordinates of one entry and
// `step` words from one entry to the next.
template <class Block>
__device__ __forceinline__ void oods_table(const Block& b, const OodsGroup& g, int first, int n, uint32_t* t,
                                           long long stride, int step) {
  if (b.tid() == 0) {
    t[0] = 1;
    t[stride] = t[2 * stride] = t[3 * stride] = 0;
  }
  b.sync();
  for (int i = 0; i < n; i++) {
    const int half = 1 << i;
    const qm31 f = oods_factor(g, first + i);
    for (int e = b.tid(); e < half; e += b.threads()) {
      const uint32_t* s = t + (long long)e * step;
      const qm31 v = qmul({s[0], s[stride], s[2 * stride], s[3 * stride]}, f);
      uint32_t* d = t + (long long)(half + e) * step;
      d[0] = v.a;
      d[stride] = v.b;
      d[2 * stride] = v.c;
      d[3 * stride] = v.d;
    }
    b.sync();
  }
}

// The partials of CTA `cta` of `n_ctas`: units [cta M / n_ctas, (cta + 1)
// M / n_ctas) of the call's M, in group order.  A unit is one (column,
// chunk) of a group: unit first + column * 2^(L-c) + chunk, whose partial
// is partial[unit].  The block's lane groups (b.group() lanes each) take
// the units of a run in turn: each lane sums a stride of the chunk's rows
// (16-byte loads where the column allows), the lane group adds its sums,
// and its first lane folds them, multiplies by B_hi[chunk] and stores.
template <class Block>
__device__ __forceinline__ void oods_cta(const Block& b, const long long* desc, long long cta, long long n_ctas,
                                         uint32_t* partial, uint32_t* sm) {
  const int G = (int)desc[0];
  const long long M = desc[1];
  const long long* ptrs = desc + OODS_HEAD + (long long)G * OODS_GROUP_WORDS;
  const long long lo = cta * M / n_ctas, hi = (cta + 1) * M / n_ctas;
  const int width = b.group(), lane = b.tid() % width, n_lg = b.threads() / width;
  for (int gi = 0; gi < G && lo < hi; gi++) {
    const OodsGroup g = oods_group(desc, gi);
    const int hl = g.L - g.c;
    const long long first = g.part0, end = first + ((long long)g.n_cols << hl);
    const long long u_lo = lo > first ? lo : first, u_hi = hi < end ? hi : end;
    if (u_lo >= u_hi) continue;
    uint32_t* blo = sm;
    uint32_t* t1 = sm + (4LL << g.c);
    uint32_t* t2 = t1 + (4LL << g.a);
    b.sync();  // the last group's tables are no longer read
    oods_table(b, g, 0, g.c, blo, 1LL << g.c, 1);
    oods_table(b, g, g.c, g.a, t1, 1, 4);
    oods_table(b, g, g.c + g.a, hl - g.a, t2, 1, 4);
    const long long n = 1LL << g.c;
    for (long long u = u_lo + b.tid() / width; u < u_hi; u += n_lg) {
      const long long col = (u - first) >> hl, chunk = (u - first) & ((1LL << hl) - 1);
      const uint32_t* x = reinterpret_cast<const uint32_t*>(ptrs[g.row0 + col]) + (chunk << g.c);
      unsigned long long s[4] = {0, 0, 0, 0};
      if (g.c >= 2 && (reinterpret_cast<uintptr_t>(x) & 15) == 0) {
        for (long long k = 4LL * lane; k < n; k += 4LL * width) {
          const u32x4 xv = *reinterpret_cast<const u32x4*>(x + k);
#pragma unroll
          for (int w = 0; w < 4; w++) {
            const u32x4 bv = *reinterpret_cast<const u32x4*>(blo + w * n + k);
#pragma unroll
            for (int e = 0; e < 4; e++) fold_mac(s[w], xv.v[e], bv.v[e]);
          }
        }
      } else {
        for (long long k = lane; k < n; k += width) {
#pragma unroll
          for (int w = 0; w < 4; w++) fold_mac(s[w], x[k], blo[w * n + k]);
        }
      }
      b.group_sum4(s);
      if (lane == 0) {
        const qm31 bhi = qmul(qload(t1 + 4 * (chunk & ((1LL << g.a) - 1))), qload(t2 + 4 * (chunk >> g.a)));
        const qm31 v = {reduce64(s[0]), reduce64(s[1]), reduce64(s[2]), reduce64(s[3])};
        qstore(partial + 4 * u, qmul(v, bhi));
      }
    }
  }
}

// Output row `row`: the sum of its partials (each below P, at most 2^(32 - c)).
template <class Block>
__device__ __forceinline__ void oods_combine_row(const Block& b, const long long* desc, long long row,
                                                 const uint32_t* partial, uint32_t* out) {
  int gi = 0;
  OodsGroup g = oods_group(desc, 0);
  while (row >= g.row0 + g.n_cols) g = oods_group(desc, ++gi);
  const long long n = 1LL << (g.L - g.c);
  const uint32_t* p = partial + 4 * (g.part0 + (row - g.row0) * n);
  unsigned long long s[4] = {0, 0, 0, 0};
  for (long long j = b.tid(); j < n; j += b.threads()) {
    const u32x4 v = *reinterpret_cast<const u32x4*>(p + 4 * j);
#pragma unroll
    for (int w = 0; w < 4; w++) s[w] += v.v[w];
  }
  b.sum4(s);
  if (b.tid() == 0) {
#pragma unroll
    for (int w = 0; w < 4; w++) out[4 * row + w] = reduce64(s[w]);
  }
}

}  // namespace lum
