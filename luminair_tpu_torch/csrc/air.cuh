// K5: the LogUp interaction columns, and K6: the constraint quotients, each
// component's tape compiled (air_tapes.cuh, generated by air/tape_cuda.py
// from air/tape.py's recordings) and every component of a phase in one
// launch.  The launch's table is a kernel parameter (WitnessArgs,
// DomainArgs), as the check's is (check.cuh).
//
// K5, per trace row r of a component: for each relation entry b, d_b = v0 +
//   alpha * v1 - z and S_b = S_{b-1} + n_b / d_b, written as coordinate rows
//   4b..4b+3 of its (4E, n) output; the last entry's rows carry the running
//   sum of the row totals S_{E-1} down the rows, from the component's
//   carry (zero, or the sum of the row blocks before this one on a mesh),
//   and its last row is the claimed sum, written into the component's row
//   of one (C, 4) output.
//   - The E inverses of a row share one M31 inversion: each d_b^-1 is
//     conj(d_b) / N(d_b) through the CM31 norm and the M31 norm N_b of
//     that, and the N_b are inverted together (prefix products, one Fermat
//     chain, 3 (E - 1) products in all; a zero N_b, where d_b = 0, stands
//     as 1 in the product, and its conjugate, zero, gives 0, as qinv's
//     inv(0) = 0 does).
//   - The running sum is a single-pass scan with decoupled look-back: a
//     CTA takes a tile of `rows` rows of one component (`items` rows a
//     thread, so that the look-back's cost is spread over more rows), its
//     index drawn from a counter (so every tile before it is already
//     running), scans its row totals, publishes the tile's aggregate,
//     sums its predecessors' aggregates back to the nearest tile that has
//     published its inclusive prefix (32 tiles a step, one warp),
//     publishes its own and writes its rows.  A component's first tile starts from its
//     carry.  Flags carry the launch's epoch, so the scratch is never
//     cleared: a flag of an earlier launch reads as not yet published.
// K6, per row r of a commit domain (or of a row shard's block of one),
//   every component whose domain it is:
//     acc = sum over components sum_i pows[i] * C_i(r)
//   over the K recorded constraints and each entry's LogUp constraint
//     (S_b(r) - S_{b-1}(r) [- S_last(r - stride) + is_first(r) * claimed]) * d_b - n_b
//   with the component's alpha powers, then acc / V_n(x_r), V_n(x) =
//   pi^(n-1)(x), once a row for all of them (one trace log a domain), and
//   one write of the (n, 4) sum.
//
// Both build with g++ too (define __host__ and __device__ empty and
// __forceinline__ inline): a CTA's work is a template on a Block (`each(f)`
// calling f(t) for every thread t, `sync()`, `scan(x)` the inclusive QM31
// prefix of x[0..threads) in place, `warp(f)` calling f(w) once for the
// CTA's first warp w, whose `ballot(f)` and `sum(f)` take f(lane) of each
// of its 32 lanes, `lane0(f)` and `pause()`), and
// tests/test_torch_air_tapes.py runs a launch's table through it on the CPU.
#pragma once

#include "tape_row.cuh"

namespace lum {

constexpr int AIR_MAX_COMPS = 32;
constexpr int AIR_MAX_COLS = 512;
constexpr int AIR_MAX_POWS = 256;
constexpr int WITNESS_THREADS = 256;  // threads of a K5 CTA
constexpr int WITNESS_MAX_ITEMS = 4;  // rows a thread of a tile, at most
constexpr int DOMAIN_THREADS = 256;   // rows of a CTA
constexpr unsigned long long SCAN_AGGREGATE = 1, SCAN_PREFIX = 2;

// The E entries' sums of one row from their multiplicities and
// denominators, through one batched M31 inversion: S_b for b < E - 1
// written at row r of out's rows 4b..4b+3 (n words apart); returns the
// row total S_{E-1}.
template <int E>
__host__ __device__ __forceinline__ qm31 witness_sums(const uint32_t (&m)[E], const qm31 (&d)[E], uint32_t* out,
                                                     long long n, long long r) {
  uint32_t den_r[E], den_i[E], norm[E], pre[E];
#pragma unroll
  for (int b = 0; b < E; b++) {
    // d = A + B u:  den = A^2 - (2 + i) B^2,  N = |den|^2
    uint32_t a2_r, a2_i, b2_r, b2_i;
    cmul(d[b].a, d[b].b, d[b].a, d[b].b, a2_r, a2_i);
    cmul(d[b].c, d[b].d, d[b].c, d[b].d, b2_r, b2_i);
    den_r[b] = sub(a2_r, sub(add(b2_r, b2_r), b2_i));
    den_i[b] = sub(a2_i, add(b2_r, add(b2_i, b2_i)));
    const uint32_t nb = add(mul(den_r[b], den_r[b]), mul(den_i[b], den_i[b]));
    norm[b] = nb + (1u - nonzero(nb));  // 1 in place of a zero norm (d = 0: den = 0, so its inverse is 0)
  }
  pre[0] = norm[0];
#pragma unroll
  for (int b = 1; b < E; b++) pre[b] = mul(pre[b - 1], norm[b]);
  uint32_t t = inv(pre[E - 1]), ninv[E];
#pragma unroll
  for (int b = E - 1; b > 0; b--) {
    ninv[b] = mul(t, pre[b - 1]);
    t = mul(t, norm[b]);
  }
  ninv[0] = t;
  qm31 s = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int b = 0; b < E; b++) {
    const uint32_t di_r = mul(den_r[b], ninv[b]), di_i = mul(neg(den_i[b]), ninv[b]);
    qm31 x;
    cmul(d[b].a, d[b].b, di_r, di_i, x.a, x.b);
    cmul(neg(d[b].c), neg(d[b].d), di_r, di_i, x.c, x.d);
    s = qadd(s, qmul_m31(x, m[b]));
    if (b < E - 1) {
      uint32_t* o = out + (long long)(4 * b) * n + r;
      o[0] = s.a;
      o[n] = s.b;
      o[2 * n] = s.c;
      o[3 * n] = s.d;
    }
  }
  return s;
}

}  // namespace lum

#include "air_tapes.cuh"

namespace lum {

// ---------------------------------------------------------------------------
// K5

// One component of a witness launch.  Mirrored by kernels.WitnessComp.
struct WitnessComp {
  long long n;               // rows, a power of two
  unsigned long long out;    // (4E, n) int32
  unsigned long long last;   // its last entry's 4 rows in out
  unsigned long long carry;  // 4 words its running sum starts from, or 0 (zero)
  int kind;                  // its compiled tape (LUM_AIR_TAPES)
  int col0;                  // its first column in WitnessArgs.cols: main, then preprocessed
  int tile0;                 // its first tile
  int pad;
};

// Mirrored by kernels.WitnessArgs.
struct WitnessArgs {
  unsigned long long cols[AIR_MAX_COLS];
  WitnessComp comps[AIR_MAX_COMPS];
  unsigned long long claimed;  // (C, 4) int32: each component's last row of its last entry
  unsigned long long flags;    // scratch: a word a tile, (epoch << 2) | SCAN_*
  unsigned long long sums;     // scratch: 8 words a tile, its aggregate then its inclusive prefix
  unsigned long long counter;  // scratch: the tiles drawn by every launch with this scratch
  unsigned long long base;     // the counter when this launch starts
  unsigned long long epoch;    // this launch's tag, above 0
  int n_comps;
  int n_tiles;
  int rows;   // rows of a tile: items rounds of the CTA's threads
  int items;  // rows a thread (at most WITNESS_MAX_ITEMS)
  uint32_t elems[TAPE_ELEM_KINDS][2][4];  // lookup elements z, alpha per kind
};

// The component of tile `t`: the last whose first tile is at or before it.
__host__ __device__ __forceinline__ int witness_comp(const WitnessArgs& a, int t) {
  int k = 0;
  for (int i = 1; i < a.n_comps; i++) k = a.comps[i].tile0 <= t ? i : k;
  return k;
}

__host__ __device__ __forceinline__ unsigned long long flag_load(const unsigned long long* p) {
#ifdef __CUDA_ARCH__
  unsigned long long v;
  asm volatile("ld.acquire.gpu.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
#else
  return *p;
#endif
}

__host__ __device__ __forceinline__ void flag_store(unsigned long long* p, unsigned long long v) {
#ifdef __CUDA_ARCH__
  asm volatile("st.release.gpu.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
#else
  *p = v;
#endif
}

// Tile k's status in this launch: 0 until it has published, then SCAN_*.
__host__ __device__ __forceinline__ unsigned scan_status(const WitnessArgs& a, int k) {
  const unsigned long long f = flag_load((const unsigned long long*)a.flags + k);
  return (f >> 2) == a.epoch ? (unsigned)(f & 3) : 0u;
}

// Tile k's published aggregate or inclusive prefix (read after its flag).
__host__ __device__ __forceinline__ qm31 scan_value(const WitnessArgs& a, int k, unsigned long long status) {
  const uint32_t* p = (const uint32_t*)a.sums + 8 * (long long)k + (status == SCAN_PREFIX ? 4 : 0);
#ifdef __CUDA_ARCH__
  const uint4 v = __ldcg((const uint4*)p);
  return {v.x, v.y, v.z, v.w};
#else
  return qload(p);
#endif
}

// Tile t's aggregate or inclusive prefix, then its flag (by one thread).
__host__ __device__ __forceinline__ void scan_publish(const WitnessArgs& a, int t, unsigned long long status,
                                                      qm31 v) {
  qstore((uint32_t*)a.sums + 8 * (long long)t + (status == SCAN_PREFIX ? 4 : 0), v);
  flag_store((unsigned long long*)a.flags + t, a.epoch << 2 | status);
}

__host__ __device__ __forceinline__ int lowest_lane(unsigned mask) {
#ifdef __CUDA_ARCH__
  return __ffs(mask) - 1;
#else
  return __builtin_ctz(mask);
#endif
}

// The sum of the row totals of tiles [first, t) of one component: lane l
// of the warp reads tile j - l, for j = t - 1, t - 33, ...; once every
// lane's tile has published, the window's sum runs from its newest tile
// that has published an inclusive prefix (lane `stop`, whose prefix is
// taken) through the aggregates of the newer ones; without one it is
// every aggregate, and the look-back moves 32 tiles on.  The component's
// first tile publishes its prefix at once, so the look-back ends there at
// the latest; tiles before it are no part of the sum.
template <class Warp>
__host__ __device__ __forceinline__ qm31 scan_lookback(const Warp& w, const WitnessArgs& a, int t, int first) {
  qm31 excl = {0u, 0u, 0u, 0u};
  for (int j = t - 1;; j -= 32) {
    while (w.ballot([&](int l) { return j - l < first || scan_status(a, j - l) != 0u; }) != ~0u) w.pause();
    const unsigned pre = w.ballot([&](int l) { return j - l >= first && scan_status(a, j - l) == SCAN_PREFIX; });
    const int stop = pre ? lowest_lane(pre) : 32;
    excl = qadd(excl, w.sum([&](int l) -> qm31 {
      if (l > stop || j - l < first) return {0u, 0u, 0u, 0u};
      return scan_value(a, j - l, l == stop ? SCAN_PREFIX : SCAN_AGGREGATE);
    }));
    if (pre) return excl;
  }
}

// One round of a tile: row row0 + tid of each thread, its total in tot[tid].
template <class Block>
__host__ __device__ __forceinline__ void witness_round(const Block& b, const WitnessArgs& a, const WitnessComp& c,
                                                       long long row0, qm31* tot) {
  b.each([&](int tid) {
    const long long r = row0 + tid;
    qm31 s = {0u, 0u, 0u, 0u};
    if (r < c.n) {
      const TapeRow<false> q{a.cols + c.col0, a.elems, nullptr, r, r, r, c.n};
      uint32_t* out = (uint32_t*)c.out;
      switch (c.kind) {
#define LUM_WITNESS_CASE(kind, name)          \
  case kind:                                  \
    s = witness_tape_##name(q, out, c.n);     \
    break;
        LUM_AIR_TAPES(LUM_WITNESS_CASE)
#undef LUM_WITNESS_CASE
        default:  // no such tape: the wrapper refuses it
          break;
      }
    }
    tot[tid] = s;
  });
}

// Tile t, first part: in `items` rounds of T = rows / items rows, each
// row's entries (the first E - 1 written) and the round's inclusive scan
// of the row totals in tot[i T..(i + 1) T); then the tile's aggregate, the
// sum of the rounds' totals, published (its inclusive prefix, from the
// carry, for a component's first tile, whose *excl is set).
template <class Block>
__host__ __device__ __forceinline__ void witness_begin(const Block& b, const WitnessArgs& a, int t, qm31* tot,
                                                       qm31* excl) {
  const WitnessComp& c = a.comps[witness_comp(a, t)];
  const int T = a.rows / a.items;
  for (int i = 0; i < a.items; i++) {
    witness_round(b, a, c, (long long)(t - c.tile0) * a.rows + (long long)i * T, tot + i * T);
    b.scan(tot + i * T);
  }
  b.each([&](int tid) {
    if (tid != 0) return;
    qm31 agg = {0u, 0u, 0u, 0u};
    for (int i = 0; i < a.items; i++) agg = qadd(agg, tot[(i + 1) * T - 1]);
    if (t == c.tile0) {
      const qm31 e = c.carry ? qload((const uint32_t*)c.carry) : qm31{0u, 0u, 0u, 0u};
      *excl = e;
      scan_publish(a, t, SCAN_PREFIX, qadd(e, agg));
    } else {
      scan_publish(a, t, SCAN_AGGREGATE, agg);
    }
  });
}

// Tile t, second part: the look-back (all but a component's first tile)
// and its inclusive prefix published; each row's running sum written into
// the last entry's rows, the component's last row also as its claimed sum.
template <class Block>
__host__ __device__ __forceinline__ void witness_end(const Block& b, const WitnessArgs& a, int t, const qm31* tot,
                                                     qm31* excl) {
  const int k = witness_comp(a, t);
  const WitnessComp& c = a.comps[k];
  const int T = a.rows / a.items;
  if (t != c.tile0) {
    b.warp([&](const auto& w) {
      const qm31 e = scan_lookback(w, a, t, c.tile0);
      w.lane0([&] {
        *excl = e;
        qm31 agg = e;
        for (int i = 0; i < a.items; i++) agg = qadd(agg, tot[(i + 1) * T - 1]);
        scan_publish(a, t, SCAN_PREFIX, agg);
      });
    });
  }
  b.sync();
  qm31 before = *excl;  // the sum of the rows before this round
  for (int i = 0; i < a.items; i++) {
    const long long row0 = (long long)(t - c.tile0) * a.rows + (long long)i * T;
    b.each([&](int tid) {
      const long long r = row0 + tid;
      if (r >= c.n) return;
      const qm31 v = qadd(before, tot[i * T + tid]);
      uint32_t* o = (uint32_t*)c.last + r;
      o[0] = v.a;
      o[c.n] = v.b;
      o[2 * c.n] = v.c;
      o[3 * c.n] = v.d;
      if (r == c.n - 1) qstore((uint32_t*)a.claimed + 4 * k, v);
    });
    before = qadd(before, tot[(i + 1) * T - 1]);
  }
}

// ---------------------------------------------------------------------------
// K6

// One component of a quotient launch.  Mirrored by kernels.DomainComp.
struct DomainComp {
  int kind;  // its compiled tape (LUM_AIR_TAPES)
  int col0;  // its first column in DomainArgs.cols: main, preprocessed, the 4E
             // interaction coordinates, is_first, a halo column per main column
             // read at the next row, the 4 halo columns of the last entry
  int pow0;  // its first alpha power in DomainArgs.pows (K + E of them)
  int pad;
  uint32_t claimed[4];  // its claimed sum
};

// One commit domain, or one row block of it, with its components.
// Mirrored by kernels.DomainSpan.
struct DomainSpan {
  long long n;             // rows, a power of two
  unsigned long long xs;   // the x coordinate of its first row (int32 words on)
  unsigned long long out;  // (n, 4) int32
  int stride;              // the next row: r + stride
  int log_trace;           // V_n's n: the trace log of its components
  int comp0;               // its components: DomainArgs.comps[comp0, comp0 + n_comps)
  int n_comps;
  int cta0;                // its first CTA
};

// Mirrored by kernels.DomainArgs.
struct DomainArgs {
  unsigned long long cols[AIR_MAX_COLS];
  DomainComp comps[AIR_MAX_COMPS];
  DomainSpan spans[AIR_MAX_COMPS];
  uint32_t pows[AIR_MAX_POWS][4];
  uint32_t elems[TAPE_ELEM_KINDS][2][4];  // lookup elements z, alpha per kind
  int n_spans;
  int n_ctas;
};

// The span of CTA `cta`: the last whose first CTA is at or before it.
__host__ __device__ __forceinline__ int domain_span(const DomainArgs& a, int cta) {
  int k = 0;
  for (int i = 1; i < a.n_spans; i++) k = a.spans[i].cta0 <= cta ? i : k;
  return k;
}

// Thread `tid` of CTA `cta` (`threads` rows a CTA): its row's quotient.
__host__ __device__ __forceinline__ void domain_cta_row(const DomainArgs& a, int cta, int tid, int threads) {
  const DomainSpan& s = a.spans[domain_span(a, cta)];
  const long long r = (long long)(cta - s.cta0) * threads + tid;
  if (r >= s.n) return;
  qm31 acc = {0u, 0u, 0u, 0u};
  for (int i = s.comp0; i < s.comp0 + s.n_comps; i++) {
    const DomainComp& c = a.comps[i];
    const TapeRow<true> q{a.cols + c.col0, a.elems, c.claimed, r, r + s.stride, r - s.stride, s.n};
    const uint32_t(*pw)[4] = a.pows + c.pow0;
    switch (c.kind) {
#define LUM_DOMAIN_CASE(kind, name)               \
  case kind:                                      \
    acc = qadd(acc, domain_tape_##name(q, pw));   \
    break;
      LUM_AIR_TAPES(LUM_DOMAIN_CASE)
#undef LUM_DOMAIN_CASE
      default:  // no such tape: the wrapper refuses it
        break;
    }
  }
  // 1 / V_n(x): n - 1 squarings pi(x) = 2x^2 - 1, then one inverse.
  uint32_t v = ((const uint32_t*)s.xs)[r];
  for (int i = 0; i < s.log_trace - 1; i++) {
    const uint32_t v2 = mul(v, v);
    v = sub(add(v2, v2), 1u);
  }
  acc = qmul_m31(acc, inv(v));
  uint32_t* o = (uint32_t*)s.out + 4 * r;
#ifdef __CUDA_ARCH__
  *(u32x4*)o = u32x4{{acc.a, acc.b, acc.c, acc.d}};
#else
  qstore(o, acc);
#endif
}

}  // namespace lum
