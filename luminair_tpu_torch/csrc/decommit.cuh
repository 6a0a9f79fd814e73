// K9's set arithmetic and gathers: the work of one CTA on one Merkle tree
// of an opening pass (csrc/decommit.cu).
//
// Compiles with g++ as well (define __host__ and __device__ empty and
// __forceinline__ inline; dc_scan and dc_tree, which take the CTA's
// Block, are device code on the card): a block of one thread, whose sync
// does nothing and whose scan is the identity, runs the same code in
// order on the CPU; the tests hold it against the plain twin.
//
// The spec is the reference's crypto/merkle.py.  Per tree of bottom log L,
// with q[l] the sorted, distinct query positions of log l:
//   comp[L] = q[L];   comp[l] = parents(comp[l+1]) | q[l]   (sorted sets)
//   witness of layer l (l = L .. 1): the children 2p, 2p+1 of each p in
//     comp[l-1] that are not in comp[l], positions ascending;
//   opened values of log l (logs with columns, L .. 0): each column at
//     comp[l], columns in commitment order.
//
// Tree descriptor (int64 words, made once per tree on its device):
//   [0] L;  [1 + 5l ...] per log l = 0..L: address of the (2^l, 8) digest
//   layer, address of the (k, 2^l) column view, k, its two strides (words).
// Pass record of one tree (int64 words, in the pass's one upload):
//   [0] descriptor address, [1] header, [2] witness and [3] values offsets
//   in the output (words); [4 + 2l], [5 + 2l] per log l = 0..31: offset and
//   count of its query positions in the positions that follow the records.
// Output of one tree: a header of (|comp[l]|, witnesses of layer l) per
// l = L .. 0, then the witness digests (8 words each) and the values, both
// packed from the start of their regions, which the host sized from upper
// bounds.
#pragma once

#include <stdint.h>

namespace lum {

constexpr int DC_MAX_LOG = 31;
constexpr int DC_DESC_WORDS = 1 + 5 * (DC_MAX_LOG + 1);
constexpr int DC_TREE_WORDS = 4 + 2 * (DC_MAX_LOG + 1);

// The number of elements of sorted a[0, n) below v (lower) or not above v
// (upper).
__host__ __device__ __forceinline__ int dc_lower(const int32_t* a, int n, long long v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (a[mid] < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__host__ __device__ __forceinline__ int dc_upper(const int32_t* a, int n, long long v) {
  return dc_lower(a, n, v + 1);
}

__host__ __device__ __forceinline__ bool dc_contains(const int32_t* a, int n, long long v) {
  int i = dc_lower(a, n, v);
  return i < n && a[i] == v;
}

// Rank in the merge of parents(prev) (prev sorted, distinct; its parents
// sorted with neighbours possibly equal) and q (sorted, distinct): parent i
// goes before the queries equal to it, query j after the parents equal to
// it.  Equal values land side by side.
__host__ __device__ __forceinline__ int dc_rank_parent(const int32_t* prev, int i, const int32_t* q, int nq) {
  return i + dc_lower(q, nq, prev[i] >> 1);
}

__host__ __device__ __forceinline__ int dc_rank_query(const int32_t* prev, int n_prev, const int32_t* q, int j) {
  return j + dc_upper(prev, n_prev, 2LL * q[j] + 1);  // parents <= q[j]: prev <= 2 q[j] + 1
}

// Witnesses of a parent p at the layer below, whose recomputed set is prev:
// its children not in prev (0, 1 or 2; the first in ascending order).
__host__ __device__ __forceinline__ int dc_missing(const int32_t* prev, int n_prev, int32_t p, int32_t* first) {
  bool has0 = dc_contains(prev, n_prev, 2LL * p), has1 = dc_contains(prev, n_prev, 2LL * p + 1);
  *first = has0 ? 2 * p + 1 : 2 * p;
  return (has0 ? 0 : 1) + (has1 ? 0 : 1);
}

// n items, `count(i)` outputs each, placed with a block-wide exclusive
// scan: emit(i, offset) for every item with outputs.  Returns the total.
// Every thread of the block calls it (it syncs).
template <class Block, class Count, class Emit>
__device__ __forceinline__ int dc_scan(const Block& b, int n, Count count, Emit emit) {
  int base = 0;
  for (int c0 = 0; c0 < n; c0 += b.threads()) {
    int i = c0 + b.tid();
    int v = i < n ? count(i) : 0;
    int total;
    int off = b.exclusive_scan(v, total);
    if (v) emit(i, base + off);
    base += total;
  }
  return base;
}

// The work of slice `slice` (of n_slices) of one tree's CTAs: every CTA
// of the tree walks the sets (in shared memory: three lists of `cap`
// positions), each gathers its share of the words.
template <class Block>
__device__ __forceinline__ void dc_tree(const Block& b, const long long* rec, const long long* positions,
                                                 int32_t* out, int slice, int n_slices, int cap, int32_t* sm) {
  const long long* desc = reinterpret_cast<const long long*>(rec[0]);
  const int L = (int)desc[0];
  int32_t* hdr = out + rec[1];
  int32_t* wit = out + rec[2];
  int32_t* val = out + rec[3];
  int32_t *prev = sm, *cur = sm + cap, *merge = sm + 2 * cap;
  const int start = slice * b.threads() + b.tid(), step = b.threads() * n_slices;
  long long n_wit = 0, n_val = 0;  // words written so far in each region

  int n_cur = (int)rec[5 + 2 * L];
  const long long* q_bottom = positions + rec[4 + 2 * L];
  for (int i = b.tid(); i < n_cur; i += b.threads()) cur[i] = (int32_t)q_bottom[i];
  b.sync();
  for (int l = L;; l--) {
    // The header, and the opened values of log l at comp[l].
    if (slice == 0 && b.tid() == 0) {
      hdr[2 * (L - l)] = n_cur;
      hdr[2 * (L - l) + 1] = 0;
    }
    const long long* d = desc + 1 + 5 * l;
    const int32_t* col = reinterpret_cast<const int32_t*>(d[1]);
    long long k = d[2], s0 = d[3], s1 = d[4];
    long long items = k * n_cur;
    for (long long t = start; t < items; t += step) {
      long long c = t / n_cur, jj = t - c * n_cur;
      val[n_val + t] = col[c * s0 + (long long)cur[jj] * s1];
    }
    n_val += items;
    if (l == 0) break;

    // comp[l-1]: merge parents(comp[l]) with q[l-1], drop repeats.
    int32_t* t_ = prev;
    prev = cur;
    cur = t_;
    const int n_prev = n_cur;
    const int nq = (int)rec[5 + 2 * (l - 1)];
    const long long* qg = positions + rec[4 + 2 * (l - 1)];
    int32_t* q = cur;  // the queries go through cur, which the merge then reuses
    for (int j = b.tid(); j < nq; j += b.threads()) q[j] = (int32_t)qg[j];
    b.sync();
    for (int i = b.tid(); i < n_prev; i += b.threads()) merge[dc_rank_parent(prev, i, q, nq)] = prev[i] >> 1;
    for (int j = b.tid(); j < nq; j += b.threads()) merge[dc_rank_query(prev, n_prev, q, j)] = q[j];
    b.sync();
    n_cur = dc_scan(
        b, n_prev + nq, [&](int r) { return r == 0 || merge[r] != merge[r - 1] ? 1 : 0; },
        [&](int r, int o) { cur[o] = merge[r]; });
    b.sync();

    // The witness of layer l: children of comp[l-1] missing from comp[l],
    // listed in `merge`, then gathered from the digest layer of log l.
    int n_w = dc_scan(
        b, n_cur, [&](int i) { int32_t first; return dc_missing(prev, n_prev, cur[i], &first); },
        [&](int i, int o) {
          int32_t first;
          int m = dc_missing(prev, n_prev, cur[i], &first);
          merge[o] = first;
          if (m == 2) merge[o + 1] = first + 1;
        });
    b.sync();
    const int32_t* layer = reinterpret_cast<const int32_t*>(desc[1 + 5 * l]);
    for (long long t = start; t < 8LL * n_w; t += step) wit[n_wit + t] = layer[8LL * merge[t >> 3] + (t & 7)];
    n_wit += 8LL * n_w;
    if (slice == 0 && b.tid() == 0) hdr[2 * (L - l) + 1] = n_w;
    b.sync();
  }
}

}  // namespace lum
