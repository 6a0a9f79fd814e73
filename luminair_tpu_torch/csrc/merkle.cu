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
// The compression is csrc/blake2s.cuh's, shared with the channel (K8/K10).

#include <cuda_runtime.h>
#include <stdint.h>

#include "blake2s.cuh"

namespace {

__global__ void merkle_layer_kernel(const uint32_t* __restrict__ prev,
                                    const uint32_t* __restrict__ cols, int n_cols,
                                    long long col_stride, long long row_stride,
                                    uint32_t* __restrict__ out, long long n_nodes) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_nodes) return;
  const int n_prev = prev ? 16 : 0;
  const int len = n_prev + n_cols;
  const int n_blocks = len > 0 ? (len + 15) / 16 : 1;
  uint32_t h[8];
  lum::blake2s_init(h);
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
    lum::blake2s_compress(h, m, t, last);
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
