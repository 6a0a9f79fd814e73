// K1's index math, butterflies and the work of one CTA (csrc/fft.cu).
//
// Compiles with g++ as well (define __host__ and __device__ empty and
// __forceinline__ inline; fft_cta, which takes the CTA's Block, is device
// code on the card): a block of one thread whose sync does nothing
// runs the same code in order on the CPU, which the tests hold against
// the plain twins and the reference.
//
// The stage with block size M pairs, inside each block of M rows,
//   inverse:  (j, M-1-j) -> (j, M/2+j):  e = (x+y)/2,  o = (x-y) * tw[j]
//   forward:  (j, M/2+j) -> (j, M-1-j):  x + tw[j]*o,  x - tw[j]*o
// with tw the stage's row of the flat twiddle table (circle.twiddle_table;
// the row of block size 2^b starts at 2^log_n - 2^b).
//
// A pass runs consecutive stages.  Those with blocks 2w, 4w, ..., 2^g w
// split every block of m = 2^g w rows into w independent groups of 2^g
// rows: group j < w holds, for q = 0 .. 2^g - 1, the rows
//   reflected:  q*w + (q odd ? w-1-j : j)
//   natural:    q*w + j
// The inverse reads a group at its reflected rows and writes it at its
// natural rows, the forward transform the other way round.  Inside the
// group, with its values at local index q = 0 .. 2^g - 1, level l (block
// 2^l w) has the form of a stage on 2^g rows: it pairs, in sub-groups of
// 2^l from c, (c+q, c+2^l-1-q) -> (c+q, c+h+q) (h = 2^(l-1), q < h) in
// the inverse, (c+q, c+h+q) -> (c+q, c+2^l-1-q) in the forward transform,
// with the twiddle of row q*w + (q odd ? w-1-j : j) of the stage's row.
// So the same split applies again inside a group: a CTA holds its groups
// in shared memory and runs their levels in chunks of at most 4, each
// chunk as mini-groups of 16 values (or fewer) that one thread keeps in
// registers, from one buffer into the other.
//
// With w = 1 the rows are the local indices: a pass over a tile of 2^g
// contiguous rows runs every stage whose block fits in the tile.
#pragma once

#include <stdint.h>

#include "m31.cuh"

namespace lum {

// Row of local index q of group j (groups of blocks 2w .. 2^g w).
__host__ __device__ __forceinline__ long long fft_row(long long w, int q, long long j, bool reflected) {
  return (long long)q * w + ((reflected && (q & 1)) ? w - 1 - j : j);
}

// Start of the twiddle row of the stage with block 2^log_m in a transform
// of 2^log_n rows (circle.stage_offset).
__host__ __device__ __forceinline__ long long fft_tw_offset(int log_n, int log_m) {
  return (1LL << log_n) - (1LL << log_m);
}

// The local index of value q of mini-group j of 2^r values in blocks of
// 2^(log_w + r): fft_row with w = 2^log_w, in 32 bits.
__host__ __device__ __forceinline__ int fft_local(int log_w, int q, int j, bool reflected) {
  return (q << log_w) + ((reflected && (q & 1)) ? (1 << log_w) - 1 - j : j);
}

// One butterfly on its two inputs: the low and high outputs.
template <bool INV>
__host__ __device__ __forceinline__ void fft_pair(uint32_t a, uint32_t b, uint32_t t, uint32_t& lo, uint32_t& hi) {
  if (INV) {
    uint32_t s = add(a, b);
    lo = (s & 1) ? (s + P) >> 1 : s >> 1;  // s / 2: s + P < 2^32
    hi = mul(sub(a, b), t);
  } else {
    uint32_t o = mul(t, b);
    lo = add(a, o);
    hi = sub(a, o);
  }
}

// Mini level LM (blocks of 2^LM of the V values in v) of a mini-group:
// every butterfly of the level, from v into nv, indices known at compile
// time.  twl: the stage's twiddle row; the butterfly qm of a block takes
// the twiddle of the local row fft_local(log_wm, qm, jm) of the pass's
// group, i.e. of row fft_local(w_log, that, jp) of the stage.
template <int V, int LM, bool INV>
__host__ __device__ __forceinline__ void fft_level(const uint32_t* v, uint32_t* nv, const uint32_t* twl, int log_wm,
                                                   int jm, int w_log, int jp) {
  constexpr int h = 1 << (LM - 1);
#pragma unroll
  for (int qm = 0; qm < h; qm++) {
    const uint32_t t = twl[fft_local(w_log, fft_local(log_wm, qm, jm, true), jp, true)];
#pragma unroll
    for (int c = 0; c < V; c += 2 * h) {
      if (INV) {
        fft_pair<true>(v[c + qm], v[c + 2 * h - 1 - qm], t, nv[c + qm], nv[c + h + qm]);
      } else {
        fft_pair<false>(v[c + qm], v[c + h + qm], t, nv[c + qm], nv[c + 2 * h - 1 - qm]);
      }
    }
  }
}

// Mini levels S+1 .. R (forward) or R-S .. 1 (inverse), one after another.
template <int R, int S, bool INV>
__host__ __device__ __forceinline__ void fft_levels(uint32_t* v, const uint32_t* tw, int log_n, int log_wm, int jm,
                                                    int w_log, int jp) {
  if constexpr (S < R) {
    constexpr int LM = INV ? R - S : S + 1;
    uint32_t nv[1 << R];
    fft_level<1 << R, LM, INV>(v, nv, tw + fft_tw_offset(log_n, log_wm + LM + w_log), log_wm, jm, w_log, jp);
#pragma unroll
    for (int q = 0; q < (1 << R); q++) v[q] = nv[q];
    fft_levels<R, S + 1, INV>(v, tw, log_n, log_wm, jm, w_log, jp);
  }
}

// The local levels a .. a+R-1 of every group a CTA holds (G groups of 2^g
// values, value q of group gi at src[q * G + gi]), read from src and
// written to dst, item i (mini-group) for i = first, first + step, ...:
// mini-group m of group gi holds 2^R values in registers.  tw: the flat
// twiddle table; w_log, j0: the pass's groups (w = 2^w_log, group gi is
// j0 + gi).
template <int R, bool INV>
__host__ __device__ __forceinline__ void fft_chunk(const uint32_t* src, uint32_t* dst, int log_g, int log_groups,
                                                   int a, const uint32_t* tw, int log_n, int w_log, long long j0,
                                                   int first, int step) {
  constexpr int V = 1 << R;
  const int log_wm = a - 1;  // the mini-groups' w, in local indices
  const int items = 1 << (log_g - R + log_groups);
  for (int i = first; i < items; i += step) {
    const int gi = i & ((1 << log_groups) - 1), m = i >> log_groups;
    const int jm = m & ((1 << log_wm) - 1);
    const int base = (m >> log_wm) << (log_wm + R);
    const int jp = (int)(j0 + gi);  // rows below 2^31: 32-bit row arithmetic
    uint32_t v[V];
#pragma unroll
    for (int q = 0; q < V; q++) v[q] = src[((base + fft_local(log_wm, q, jm, INV)) << log_groups) + gi];
    fft_levels<R, 0, INV>(v, tw, log_n, log_wm, jm, w_log, jp);
#pragma unroll
    for (int q = 0; q < V; q++) dst[((base + fft_local(log_wm, q, jm, !INV)) << log_groups) + gi] = v[q];
  }
}

// Value of row x of the low-degree extension of a column of coefficients
// (src_col, 2^(log_n - log_blowup) words): the zero-strided embedding, or
// each coefficient twice when `dup` (blowup 1, whose first stage, block 2,
// maps [c, 0] to [c, c]; the pass then starts at block 4).
__host__ __device__ __forceinline__ uint32_t fft_lde_value(const uint32_t* src_col, long long x, int log_blowup,
                                                           bool dup) {
  if (dup) return src_col[x >> 1];
  return (x & ((1LL << log_blowup) - 1)) ? 0u : src_col[x >> log_blowup];
}

struct alignas(16) FftWords4 {
  uint32_t w[4];
};

struct FftPass {
  const uint32_t* src;  // (n_cols, 2^log_n), or the (n_cols, 2^(log_n - log_blowup)) coefficients of an LDE
  uint32_t* dst;        // (n_cols, 2^log_n); may be src for a pass with log_w = 0
  const uint32_t* tw;   // the flat twiddle table of 2^log_n rows
  long long n_cols;
  int log_n;
  int log_g;       // group: 2^log_g values
  int log_w;       // groups per block: 2^log_w (0: a tile of contiguous rows)
  int log_groups;  // groups per CTA: 2^log_groups <= 2^log_w
  int l_lo, l_hi;  // levels run: l_hi down to l_lo (inverse), l_lo up to l_hi (forward)
  int inverse;
  int log_blowup;  // > 0: src holds coefficients, read through fft_lde_value
  int dup;
};

// CTAs of a pass: each holds 2^(log_g + log_groups) words.
__host__ __device__ __forceinline__ long long fft_ctas(const FftPass& p) {
  return (p.n_cols << p.log_n) >> (p.log_g + p.log_groups);
}

template <bool INV>
__host__ __device__ __forceinline__ void fft_chunk_r(int r, const uint32_t* src, uint32_t* dst, int log_g,
                                                     int log_groups, int a, const uint32_t* tw, int log_n, int w_log,
                                                     long long j0, int first, int step) {
  switch (r) {
    case 1: fft_chunk<1, INV>(src, dst, log_g, log_groups, a, tw, log_n, w_log, j0, first, step); break;
    case 2: fft_chunk<2, INV>(src, dst, log_g, log_groups, a, tw, log_n, w_log, j0, first, step); break;
    case 3: fft_chunk<3, INV>(src, dst, log_g, log_groups, a, tw, log_n, w_log, j0, first, step); break;
    default: fft_chunk<4, INV>(src, dst, log_g, log_groups, a, tw, log_n, w_log, j0, first, step); break;
  }
}

// Levels per register chunk: 16 values per thread, four levels per round
// trip through shared memory.
constexpr int FFT_CHUNK = 4;

// The work of CTA `cta` of a pass; `sm` holds two buffers of
// 2^(log_g + log_groups) words, slot q * G + (group index) for
// G = 2^log_groups.  Block: tid(), threads(), sync().
template <class Block>
__device__ __forceinline__ void fft_cta(const Block& b, const FftPass& p, long long cta, uint32_t* sm) {
  const int G = 1 << p.log_groups;
  const int words = G << p.log_g;
  const long long w = 1LL << p.log_w;
  const int log_m = p.log_g + p.log_w;
  const long long chunks = w >> p.log_groups;  // CTAs per block
  const long long blocks = 1LL << (p.log_n - log_m);
  const long long chunk = cta % chunks;
  const long long blk = (cta / chunks) % blocks;
  const long long col = cta / (chunks * blocks);
  const long long j0 = chunk << p.log_groups;
  const long long row0 = blk << log_m;
  const long long n = 1LL << p.log_n;
  uint32_t* dst = p.dst + col * n + row0;
  const bool lde = p.log_blowup > 0;
  const uint32_t* src_col = p.src + (lde ? col * (n >> p.log_blowup) : col * n);
  uint32_t *cur = sm, *other = sm + words;  // the two buffers

  // Load: 16-byte words where the rows are contiguous and aligned.
  const bool vec = p.log_w == 0 && p.log_g >= 2 && !lde && ((uintptr_t)(src_col + row0) & 15) == 0 &&
                   ((uintptr_t)dst & 15) == 0;
  if (vec) {
    const FftWords4* s4 = reinterpret_cast<const FftWords4*>(src_col + row0);
    for (int i = b.tid(); i < words / 4; i += b.threads()) reinterpret_cast<FftWords4*>(cur)[i] = s4[i];
  } else {
    for (int i = b.tid(); i < words; i += b.threads()) {
      int gi = i & (G - 1), q = i >> p.log_groups;
      long long x = row0 + fft_row(w, q, j0 + gi, p.inverse != 0);
      cur[i] = lde ? fft_lde_value(src_col, x, p.log_blowup, p.dup != 0) : src_col[x];
    }
  }
  b.sync();
  // The levels in chunks of at most FFT_CHUNK, in the order they run.
  for (int done = 0; done <= p.l_hi - p.l_lo;) {
    int r = p.l_hi - p.l_lo + 1 - done;
    r = r < FFT_CHUNK ? r : FFT_CHUNK;
    if (p.inverse) {
      fft_chunk_r<true>(r, cur, other, p.log_g, p.log_groups, p.l_hi - done - r + 1, p.tw, p.log_n, p.log_w, j0,
                        b.tid(), b.threads());
    } else {
      fft_chunk_r<false>(r, cur, other, p.log_g, p.log_groups, p.l_lo + done, p.tw, p.log_n, p.log_w, j0, b.tid(),
                         b.threads());
    }
    done += r;
    uint32_t* t = cur;
    cur = other;
    other = t;
    b.sync();
  }
  const uint32_t* out = cur;
  if (vec) {
    FftWords4* d4 = reinterpret_cast<FftWords4*>(dst);
    for (int i = b.tid(); i < words / 4; i += b.threads()) d4[i] = reinterpret_cast<const FftWords4*>(out)[i];
  } else {
    for (int i = b.tid(); i < words; i += b.threads()) {
      int gi = i & (G - 1), q = i >> p.log_groups;
      dst[fft_row(w, q, j0 + gi, p.inverse == 0)] = out[i];
    }
  }
}

}  // namespace lum
