// One row of one component as the compiled tapes read it: the constraint
// check (check.cuh, check_tapes.cuh), K5's witness and K6's quotients
// (air.cuh, air_tapes.cuh).  Every column is a compile-time index into the
// component's column table (main columns, preprocessed columns, the 4E
// interaction coordinates, is_first, then K6's halo columns), so the
// generated code has no interpreter loop and no register array.
//
// Builds with g++ too (define __host__ and __device__ empty and
// __forceinline__ inline).
#pragma once

#include "m31.cuh"

namespace lum {

constexpr int TAPE_ELEM_KINDS = 5;  // lookup-element kinds (kernels.ELEM_KINDS)

// 1 when x (below 2^31) is nonzero, else 0, by integer operations alone.
// A constraint's bit is set with this and not with a comparison: from
// (x != 0u ? 1u : 0u) ORed into the word, ptxas (CUDA 12.9, -O1 and above)
// built max_reduce's check with bits 5 and 13 lost on every row; with
// ptxas -O0, or with this form, every component's word equals the twin's.
__host__ __device__ __forceinline__ uint32_t nonzero(uint32_t x) { return (x | (0u - x)) >> 31; }

// The word at `row` of the column whose address is `addr`, the address
// taken as an integer: a halo column's address is offset by the rows it
// stands in for (air.cuh), so the row may lie outside [0, rows).
__host__ __device__ __forceinline__ uint32_t word_at(unsigned long long addr, long long row) {
  return *(const uint32_t*)(addr + 4ull * (unsigned long long)row);
}

// Row r of one component.
//   Halo = false (the check, K5): rn and rp are the next and the previous
//     rows of a cyclic column of n rows.
//   Halo = true (K6): rn = r + stride and rp = r - stride in a block of n
//     rows (a whole commit domain, or a row shard's block of one).  A read
//     past the block's end (rn >= n) goes to the halo column of the main
//     column read at the next row, and a read before its start (rp < 0) to
//     the 4 halo columns of the last entry's coordinates; their addresses
//     are offset so that rn and rp reach them unchanged.  For a whole
//     domain the halo columns are the block's own, offset by n rows: the
//     reads wrap.
template <bool Halo>
struct TapeRow {
  const unsigned long long* cols;  // the component's column table
  const uint32_t (*elems)[2][4];   // lookup elements z, alpha per kind
  const uint32_t* claimed;         // its claimed sum (the LogUp constraint of its last entry)
  long long r, rn, rp;             // this row, the next and the previous
  long long n;                     // rows of the block

  __host__ __device__ __forceinline__ uint32_t at(int i) const { return ((const uint32_t*)cols[i])[r]; }
  // The check's next row (cyclic).
  __host__ __device__ __forceinline__ uint32_t next(int i) const { return ((const uint32_t*)cols[i])[rn]; }
  // K6's next row: main column i, or past the block's end its halo column h.
  __host__ __device__ __forceinline__ uint32_t next(int i, int h) const {
    return word_at(cols[rn < n ? i : h], rn);
  }
  __host__ __device__ __forceinline__ qm31 quad(int i, long long row) const {
    return {word_at(cols[i], row), word_at(cols[i + 1], row), word_at(cols[i + 2], row), word_at(cols[i + 3], row)};
  }
  // The 4 coordinates of columns Col.. at the previous row: with a halo,
  // before the block's start from the halo columns Prev...
  template <int Col, int Prev>
  __host__ __device__ __forceinline__ qm31 before() const {
    if constexpr (Halo) {
      return quad(rp >= 0 ? Col : Prev, rp);
    } else {
      return quad(Col, rp);
    }
  }

  // d = v0 + alpha * v1 - z: an entry's combined lookup value; Kind: its
  // lookup elements, Two: a relation of two values.
  template <int Kind, bool Two>
  __host__ __device__ __forceinline__ qm31 denom(uint32_t v0, uint32_t v1) const {
    qm31 d = qsub({v0, 0u, 0u, 0u}, qload(elems[Kind][0]));
    if constexpr (Two) d = qadd(d, qmul_m31(qload(elems[Kind][1]), v1));
    return d;
  }

  // The LogUp constraint of the entry whose sums start at column Col:
  //     (S_b - S_{b-1} [- S_last(rp) + is_first * claimed]) * d_b - n_b.
  // `prev` holds S_{b-1} (zero before the first entry) and becomes S_b.
  // First: is_first's column for the last entry, -1 for the others; Prev:
  // the last entry's previous-row halo (K6), -1 without one.
  template <int Col, int Kind, bool Two, int First, int Prev = -1>
  __host__ __device__ __forceinline__ qm31 logup_value(qm31& prev, uint32_t m, uint32_t v0, uint32_t v1) const {
    const qm31 s = quad(Col, r);
    qm31 diff = qsub(s, prev);
    if constexpr (First >= 0) {
      diff = qadd(qsub(diff, before<Col, Prev>()), qmul_m31(qload(claimed), at(First)));
    }
    prev = s;
    return qsub(qmul(diff, denom<Kind, Two>(v0, v1)), {m, 0u, 0u, 0u});
  }

  // The check's bit: 1 when that constraint does not vanish, else 0.
  template <int Col, int Kind, bool Two, int First>
  __host__ __device__ __forceinline__ uint32_t logup(qm31& prev, uint32_t m, uint32_t v0, uint32_t v1) const {
    const qm31 e = logup_value<Col, Kind, Two, First>(prev, m, v0, v1);
    return nonzero(e.a | e.b | e.c | e.d);
  }
};

}  // namespace lum
