// T4's work (csrc/trace.cu): the boundary of one LUT node of the settings
// pre-pass, [min(src), max(src), gathered...] as int64 -- the reference's
// one result (inp, jnp.min(sbuf), jnp.max(sbuf)) of its segment program
// (luminair_tpu/graph/device_trace.py :552-556), which the host downloads
// in one copy to compute the LUT's outputs.
//
// The CTA body is a template on a Block (`threads()`, `sync()`, `each(f)`
// calling f(t) for every thread t, and `minmax(lo, hi)`, which leaves the
// least of lo[0..T) in lo[0] and the largest of hi[0..T) in hi[0]), so a
// block of T host threads run in turn builds it with g++
// (tests/test_torch_lut.py).  Each thread takes up to LUT_PAIRS 16-byte
// pairs of the source a pass, all loaded before any is compared, so a pass
// waits on one memory latency (the element before the first 16-byte
// boundary and the one after the last pair go to thread 0 of CTA 0); the
// gathered input is copied the same way, LUT_COPY values a thread a pass,
// first, so that its stores drain while the source's loads are in flight.
//
// Several CTAs wherever the source has more than LUT_PAIRS pairs a thread
// of one CTA: one CTA of 1024 threads moved the PINN's 16,384 + 16,384
// values at 57 GB/s, one SM's share (6.85 us on an H100 80GB HBM3), so the work
// is spread over the SMs.  Each CTA writes its partial into the scratch at
// the end of `out`; the last CTA to finish (a ticket counter after a
// fence) reads the partials, one a thread (of the card's), reduces them as
// it reduced its own values, writes the result and puts the counter back to 0 for the
// next launch.  A last-CTA pass rather than 64-bit atomicMin / atomicMax
// on the result: those need the result initialised before any CTA's
// atomic, which one launch cannot order without the same counter.
#pragma once

#include <stdint.h>

namespace lum {

constexpr int LUT_THREADS = 256;  // the card's CTA
constexpr int LUT_PAIRS = 4;      // pairs a thread before a second CTA is taken
constexpr int LUT_COPY = 8;       // gathered values a thread a pass
constexpr int LUT_MAX_CTAS = 256;
constexpr long long LUT_I64_MAX = 0x7fffffffffffffffLL;
constexpr long long LUT_I64_MIN = -LUT_I64_MAX - 1;

struct LutArgs {
  const long long* src;
  long long n;  // > 0
  const long long* gathered;
  long long gn;
  long long* out;       // gn + 2 result words, then (several CTAs) the scratch
  long long out_words;  // out's length: partials at [out_words - 1 - 2G, out_words - 1), the counter last
};

__host__ __device__ __forceinline__ long long lut_ctas(long long n, int threads) {
  const long long per = 2LL * LUT_PAIRS * threads;
  const long long g = (n + per - 1) / per;
  return g < 1 ? 1 : (g > LUT_MAX_CTAS ? LUT_MAX_CTAS : g);
}

// Words of `out` a launch of `threads` a CTA needs.
__host__ __device__ __forceinline__ long long lut_boundary_words(long long n, long long gn, int threads) {
  const long long g = lut_ctas(n, threads);
  return gn + 2 + (g > 1 ? 2 * g + 1 : 0);
}

__host__ __device__ __forceinline__ void lut_pair(const long long* p, long long& v0, long long& v1) {
#ifdef __CUDA_ARCH__
  const longlong2 v = __ldg(reinterpret_cast<const longlong2*>(p));
  v0 = v.x;
  v1 = v.y;
#else
  v0 = p[0];
  v1 = p[1];
#endif
}

__host__ __device__ __forceinline__ long long lut_load(const long long* p) {
#ifdef __CUDA_ARCH__
  return __ldg(p);
#else
  return *p;
#endif
}

// A partial written by another CTA: read through L2, past this SM's L1.
__host__ __device__ __forceinline__ long long lut_shared_load(const long long* p) {
#ifdef __CUDA_ARCH__
  return __ldcg(p);
#else
  return *p;
#endif
}

// This CTA's place among the CTAs that have finished (its partial fenced first).
__host__ __device__ __forceinline__ unsigned long long lut_ticket(unsigned long long* counter) {
#ifdef __CUDA_ARCH__
  __threadfence();
  return atomicAdd(counter, 1ull);
#else
  return (*counter)++;
#endif
}

__host__ __device__ __forceinline__ void lut_take(long long v, long long& mn, long long& mx) {
  mn = v < mn ? v : mn;
  mx = v > mx ? v : mx;
}

// lo[T], hi[T] and *last are the CTA's shared memory.
template <class Block>
__device__ __forceinline__ void lut_boundary_cta(const Block& b, const LutArgs& a, long long cta, long long grid,
                                                 long long* lo, long long* hi, int* last) {
  const int T = b.threads();
  const long long head = (reinterpret_cast<uintptr_t>(a.src) & 15) ? 1 : 0;
  const long long pairs = (a.n - head) / 2;
  const long long tail = head + 2 * pairs;  // an element after the last pair when < n
  const long long stride = grid * T;
  b.each([&](int t) {
    for (long long i0 = cta * T + t; i0 < a.gn; i0 += LUT_COPY * stride) {
      long long v[LUT_COPY];
#pragma unroll
      for (int j = 0; j < LUT_COPY; j++)
        if (i0 + j * stride < a.gn) v[j] = lut_load(a.gathered + i0 + j * stride);
#pragma unroll
      for (int j = 0; j < LUT_COPY; j++)
        if (i0 + j * stride < a.gn) a.out[2 + i0 + j * stride] = v[j];
    }
  });
  b.each([&](int t) {
    long long mn = LUT_I64_MAX, mx = LUT_I64_MIN;
    const long long first = cta * T + t;
    for (long long k0 = first; k0 < pairs; k0 += LUT_PAIRS * stride) {
      long long v0[LUT_PAIRS], v1[LUT_PAIRS];
#pragma unroll
      for (int j = 0; j < LUT_PAIRS; j++)
        if (k0 + j * stride < pairs) lut_pair(a.src + head + 2 * (k0 + j * stride), v0[j], v1[j]);
#pragma unroll
      for (int j = 0; j < LUT_PAIRS; j++) {
        if (k0 + j * stride < pairs) {
          lut_take(v0[j], mn, mx);
          lut_take(v1[j], mn, mx);
        }
      }
    }
    if (first == 0) {
      if (head) lut_take(a.src[0], mn, mx);
      if (tail < a.n) lut_take(a.src[tail], mn, mx);
    }
    lo[t] = mn;
    hi[t] = mx;
  });
  b.minmax(lo, hi);
  long long* part = a.out + a.out_words - 1 - 2 * grid;
  auto* counter = reinterpret_cast<unsigned long long*>(a.out + a.out_words - 1);
  b.each([&](int t) {
    if (t != 0) return;
    *last = grid == 1;
    if (grid == 1) return;
    part[2 * cta] = lo[0];
    part[2 * cta + 1] = hi[0];
    *last = lut_ticket(counter) == (unsigned long long)(grid - 1);
  });
  b.sync();
  if (!*last) return;  // the same for every thread of the CTA
  if (grid > 1) {
    b.each([&](int t) {
      long long mn = LUT_I64_MAX, mx = LUT_I64_MIN;
      for (long long c = t; c < grid; c += T) {
        const long long lo_c = lut_shared_load(part + 2 * c), hi_c = lut_shared_load(part + 2 * c + 1);
        mn = lo_c < mn ? lo_c : mn;
        mx = hi_c > mx ? hi_c : mx;
      }
      lo[t] = mn;
      hi[t] = mx;
    });
    b.minmax(lo, hi);
  }
  b.each([&](int t) {
    if (t != 0) return;
    a.out[0] = lo[0];
    a.out[1] = hi[0];
    if (grid > 1) *counter = 0;
  });
}

}  // namespace lum
