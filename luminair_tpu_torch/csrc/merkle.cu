// K2: one layer of a mixed-size Blake2s-256 Merkle tree.
//
// Replaces the JAX package's `_jit_merkle_tree`, `_scan_tree_top` and
// `_dev_tree_layers` (parallel/accel.py), which trace
// crypto/blake2s.hash_words over the concatenated message matrix.
//
// One thread per node i of a layer of 2^log_n nodes.  Its message is
//   [child 2i digest, child 2i+1 digest] (16 words, absent on the leaf
//   layer) followed by word i of each of the n_cols columns of this log,
// read straight from the column buffer through its strides
// (cols[c * col_stride + i * row_stride]), so the (nodes, L) message matrix
// is never written to device memory.  ceil(L/16) compressions with the
// Blake2s byte counter and last-block flag of crypto/blake2s.hash_words;
// the digest is the 8 little-endian state words, as hashlib gives them.
//
// Bound on this card: the integer ALU -- 10 rounds of 8 G functions (about
// 14 ops each) per 64-byte block, against 4 bytes read per message word.
// The message block lives in registers (the rounds are written out with
// literal SIGMA indices so nothing spills to local memory).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t rotr(uint32_t x, int n) { return __funnelshift_r(x, x, n); }

#define G(a, b, c, d, x, y) \
  a = a + b + (x);          \
  d = rotr(d ^ a, 16);      \
  c = c + d;                \
  b = rotr(b ^ c, 12);      \
  a = a + b + (y);          \
  d = rotr(d ^ a, 8);       \
  c = c + d;                \
  b = rotr(b ^ c, 7);

#define ROUND(s0, s1, s2, s3, s4, s5, s6, s7, s8, s9, s10, s11, s12, s13, s14, s15) \
  G(v0, v4, v8, v12, m[s0], m[s1])                                                 \
  G(v1, v5, v9, v13, m[s2], m[s3])                                                 \
  G(v2, v6, v10, v14, m[s4], m[s5])                                                \
  G(v3, v7, v11, v15, m[s6], m[s7])                                                \
  G(v0, v5, v10, v15, m[s8], m[s9])                                                \
  G(v1, v6, v11, v12, m[s10], m[s11])                                              \
  G(v2, v7, v8, v13, m[s12], m[s13])                                               \
  G(v3, v4, v9, v14, m[s14], m[s15])

constexpr uint32_t IV0 = 0x6A09E667u, IV1 = 0xBB67AE85u, IV2 = 0x3C6EF372u, IV3 = 0xA54FF53Au,
                   IV4 = 0x510E527Fu, IV5 = 0x9B05688Cu, IV6 = 0x1F83D9ABu, IV7 = 0x5BE0CD19u;

__device__ __forceinline__ void compress(uint32_t h[8], const uint32_t m[16], uint32_t t, bool last) {
  uint32_t v0 = h[0], v1 = h[1], v2 = h[2], v3 = h[3], v4 = h[4], v5 = h[5], v6 = h[6], v7 = h[7];
  uint32_t v8 = IV0, v9 = IV1, v10 = IV2, v11 = IV3;
  uint32_t v12 = IV4 ^ t, v13 = IV5, v14 = last ? ~IV6 : IV6, v15 = IV7;
  ROUND(0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15)
  ROUND(14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3)
  ROUND(11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4)
  ROUND(7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8)
  ROUND(9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13)
  ROUND(2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9)
  ROUND(12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11)
  ROUND(13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10)
  ROUND(6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5)
  ROUND(10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0)
  h[0] ^= v0 ^ v8;
  h[1] ^= v1 ^ v9;
  h[2] ^= v2 ^ v10;
  h[3] ^= v3 ^ v11;
  h[4] ^= v4 ^ v12;
  h[5] ^= v5 ^ v13;
  h[6] ^= v6 ^ v14;
  h[7] ^= v7 ^ v15;
}

__global__ void merkle_layer_kernel(const uint32_t* __restrict__ prev,
                                    const uint32_t* __restrict__ cols, int n_cols,
                                    long long col_stride, long long row_stride,
                                    uint32_t* __restrict__ out, long long n_nodes) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_nodes) return;
  const int n_prev = prev ? 16 : 0;
  const int len = n_prev + n_cols;
  const int n_blocks = len > 0 ? (len + 15) / 16 : 1;
  uint32_t h[8] = {IV0 ^ 0x01010020u, IV1, IV2, IV3, IV4, IV5, IV6, IV7};
  for (int blk = 0; blk < n_blocks; blk++) {
    uint32_t m[16];
#pragma unroll
    for (int w = 0; w < 16; w++) {
      int g = blk * 16 + w;
      uint32_t word = 0;
      if (g < n_prev) {
        word = prev[16 * i + g];
      } else if (g < len) {
        word = cols[(long long)(g - n_prev) * col_stride + i * row_stride];
      }
      m[w] = word;
    }
    bool last = blk == n_blocks - 1;
    uint32_t t = last ? (uint32_t)(4 * len) : (uint32_t)(64 * (blk + 1));
    compress(h, m, t, last);
  }
#pragma unroll
  for (int w = 0; w < 8; w++) out[8 * i + w] = h[w];
}

}  // namespace

extern "C" int lum_merkle_layer(const uint32_t* prev, const uint32_t* cols, int n_cols,
                                long long col_stride, long long row_stride, uint32_t* out,
                                long long n_nodes, void* stream) {
  if (n_nodes > 0) {
    merkle_layer_kernel<<<(unsigned)((n_nodes + 127) / 128), 128, 0, (cudaStream_t)stream>>>(
        prev, cols, n_cols, col_stride, row_stride, out, n_nodes);
  }
  return (int)cudaGetLastError();
}
