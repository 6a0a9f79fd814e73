// K2: a whole mixed-size Blake2s-256 Merkle tree in a few launches.
//
// Replaces the JAX package's `_jit_merkle_tree` (parallel/accel.py:853),
// `_scan_tree_top` (:1361) and `_dev_tree_layers` (:1464), which trace
// crypto/blake2s.hash_words over the concatenated message matrix and hash
// a whole tree as one program.
//
// The tree's layers are views of one buffer; its descriptor (the one the
// decommitment pass reads) is uploaded once, before the hashing.  A pass
// is one launch of merkle_pass_kernel: each CTA hashes 2^t nodes of the
// pass's first layer -- the leaves on the first pass, reading the columns
// straight from their buffers through the descriptor's strides, so no
// message matrix is written -- and then the t layers above them, children
// read from shared memory (merkle.cuh).  Passes repeat until the root: a
// tree of 2^L leaves takes ceil((L + 1) / (t + 1)) launches, one for a
// tree of up to 2^t leaves.
//
// A FRI layer's tree also carries K8's channel step: its root pass (the
// last, one CTA) is merkle_pass_kernel<true>, whose thread that writes the
// root mixes it into the FRI record's channel state and draws the layer's
// alpha (merkle.cuh).  Every other tree runs merkle_pass_kernel<false>.
//
// Bound on this card: the integer ALU -- 10 rounds of 8 G functions (12
// instructions each: IADD3 adds three words, PRMT rotates by 16 and 8, one
// SHF by 12 and 7) and 8 LOP3s per 64-byte block, against 4 bytes read per
// column word and 32 bytes written per node.  The compression is csrc/blake2s.cuh's,
// shared with the channel (K8/K10).

#include <cuda_runtime.h>
#include <stdint.h>

#include "merkle.cuh"

namespace {

constexpr int TILE_LOG = 10;  // a CTA owns 2^10 nodes of its pass's first layer: 52 KB of digests
constexpr int THREADS = 256;  // at most; one node of the tile's first layer per thread and turn

struct DeviceBlock {
  __device__ __forceinline__ int tid() const { return threadIdx.x; }
  __device__ __forceinline__ int threads() const { return blockDim.x; }
  __device__ __forceinline__ void sync() const { __syncthreads(); }
};

template <bool Channel>
__global__ void __launch_bounds__(THREADS) merkle_pass_kernel(lum::MerklePass p) {
  extern __shared__ uint32_t sm[];
  lum::merkle_cta<DeviceBlock, Channel>(DeviceBlock{}, p, blockIdx.x, sm);
}

}  // namespace

extern "C" long long lum_merkle_tile_log() { return TILE_LOG; }
extern "C" long long lum_merkle_pass_size() { return (long long)sizeof(lum::MerklePass); }

// One pass of a tree; state and slot (both 0, or both set on the pass that
// writes layer 0) give its root pass K8's channel step.
extern "C" int lum_merkle_pass(unsigned long long desc, int bottom, unsigned long long state, unsigned long long slot,
                               void* stream) {
  // The attribute is a device's: set it once on each device (the caller
  // makes the tensors' device current).
  constexpr int MAX_DEVICES = 64;
  static bool smem_set[MAX_DEVICES] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (!smem_set[dev]) {
    const int bytes = (int)(lum::merkle_smem_words(TILE_LOG) * sizeof(uint32_t));
    const cudaFuncAttribute smem_attr = cudaFuncAttributeMaxDynamicSharedMemorySize;
    cudaError_t err = cudaFuncSetAttribute(merkle_pass_kernel<false>, smem_attr, bytes);
    if (err == cudaSuccess) err = cudaFuncSetAttribute(merkle_pass_kernel<true>, smem_attr, bytes);
    if (err != cudaSuccess) return (int)err;
    smem_set[dev] = true;
  }
  const lum::MerklePass p{desc, bottom, TILE_LOG, state, slot};
  if (bottom < 0 || (state == 0) != (slot == 0) || (state != 0 && lum::merkle_tile(p) != bottom))
    return (int)cudaErrorInvalidValue;  // a channel only on the pass that writes the root
  const int t = lum::merkle_tile(p);
  int threads = 1 << t;
  threads = threads < 32 ? 32 : threads > THREADS ? THREADS : threads;
  const size_t smem = lum::merkle_smem_words(t) * sizeof(uint32_t);
  if (state)
    merkle_pass_kernel<true><<<(unsigned)lum::merkle_ctas(p), threads, smem, (cudaStream_t)stream>>>(p);
  else
    merkle_pass_kernel<false><<<(unsigned)lum::merkle_ctas(p), threads, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
