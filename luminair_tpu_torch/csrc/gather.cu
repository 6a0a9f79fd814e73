// K9: every gather of one decommitment pass in one launch.
//
// Replaces the JAX package's `_jit_gather_cols` and `_jit_gather_many`
// (parallel/accel.py): the opened column values and the Merkle witness
// digests of a whole opening pass, gathered on the device into one flat
// buffer that comes to the host in one transfer.  The reference pads each
// index vector to a power of two so XLA's executable shapes stay stable;
// nothing here needs that.
//
// The host packs one int64 table, uploaded in one pinned copy: n_specs
// rows of SPEC_WORDS = {source address, stride 0, stride 1, axis, width,
// index count, index offset, output offset}, then the concatenated
// indices.  A spec reads a 2-D int32 view through its two strides (in
// elements):
//   axis 0: out[j, w] = src[idx[j] * stride0 + w * stride1], w < width
//           (the rows of a (2^l, 8) digest layer: width 8);
//   axis 1: out[c, j] = src[c * stride0 + idx[j] * stride1], c < width
//           (the columns of a (k, 2^l) view: width k);
// each result row-major at its output offset.  One thread per output word
// finds its spec by a binary search over the output offsets (specs are
// packed in output order, none empty).
//
// Bound on this card: device memory -- each gathered word is read once
// and written once, 4 bytes each, plus the table.  Scattered 4-byte reads
// use a 32-byte sector each; the passes are small (tens to hundreds of
// KB), so the launch and the transfers dominate.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SPEC_WORDS = 8;

__global__ void gather_kernel(const long long* __restrict__ table, int n_specs, long long n_words,
                              int32_t* __restrict__ out) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_words) return;
  int lo = 0, hi = n_specs - 1;  // the last spec whose output offset is <= i
  while (lo < hi) {
    int mid = (lo + hi + 1) / 2;
    if (table[mid * SPEC_WORDS + 7] <= i) lo = mid; else hi = mid - 1;
  }
  const long long* s = table + lo * SPEC_WORDS;
  const int32_t* src = reinterpret_cast<const int32_t*>(s[0]);
  const long long* idx = table + (long long)n_specs * SPEC_WORDS + s[6];
  long long width = s[4], n_idx = s[5], k = i - s[7];
  long long a = k / (s[3] == 0 ? width : n_idx);
  long long b = k - a * (s[3] == 0 ? width : n_idx);
  long long pos = s[3] == 0 ? idx[a] * s[1] + b * s[2] : a * s[1] + idx[b] * s[2];
  out[i] = src[pos];
}

}  // namespace

extern "C" long long lum_gather_spec_words() { return SPEC_WORDS; }

extern "C" int lum_gather(const long long* table, int n_specs, long long n_words, int32_t* out,
                          void* stream) {
  if (n_words > 0) {
    gather_kernel<<<(unsigned)((n_words + 255) / 256), 256, 0, (cudaStream_t)stream>>>(
        table, n_specs, n_words, out);
  }
  return (int)cudaGetLastError();
}
