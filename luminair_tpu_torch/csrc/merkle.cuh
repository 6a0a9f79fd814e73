// K2's CTA: one tile of a mixed-size Blake2s Merkle tree -- 2^t nodes of
// one layer and the t layers above them, inner digests in shared memory
// (csrc/merkle.cu).
//
// Compiles with g++ as well (define __host__ and __device__ empty and
// __forceinline__ inline): a block of one thread, whose sync does
// nothing, runs the same code in order on the CPU; the tests hold it
// against the plain twin (kernels.merkle_tree_plain).
//
// The tree is read and written through its descriptor, the one the
// decommitment pass reads (decommit.cuh; int64 words, made once per
// tree): [0] the bottom log L; [1 + 5l ...] per log l = 0..L: address of
// the (2^l, 8) digest layer, address of the (k, 2^l) column view, k, its
// two strides (words).  Node i of layer l hashes the message
//   [digest 2i, digest 2i+1 of layer l + 1] (absent on layer L)
//   followed by word i of each of the k columns of log l,
// in ceil((16 + k) / 16) compressions with the byte counter and last-block
// flag of crypto/blake2s.hash_words_plain; the digest is the 8
// little-endian state words, as hashlib gives them.
//
// A pass (MerklePass) hashes layers bottom .. bottom - t, t = min(tile
// log, bottom): CTA c owns nodes [c 2^t, (c + 1) 2^t) of layer `bottom`
// and their ancestors.  It reads the children of its first layer from
// device memory (the layer the previous pass wrote), keeps every later
// layer's children in shared memory, and writes every digest it computes
// to its layer, which the decommitment reads.  A tree of bottom log L
// takes ceil((L + 1) / (t + 1)) passes (kernels.merkle_passes).
//
// The pass that writes layer 0 is one CTA.  A FRI layer's tree gives that
// pass a channel (K8's step; `state` and `slot` not null, merkle_cta's
// Channel parameter true): thread 0, which computes the root, reads the
// channel state into registers when the pass starts, so the read waits
// behind the tile's hashing; at the root it mixes the root into that copy
// and draws the layer's alpha (channel.cuh's mix_root and draw_felt), then
// writes the state and the layer's record slot {root[8], alpha[4]}.
// Nothing else is read from memory but the state, and no launch is spent
// on the step.  Trees without a channel compile and run as before.
#pragma once

#include <stdint.h>

#include "blake2s.cuh"
#include "channel.cuh"

namespace lum {

struct MerklePass {
  unsigned long long desc;  // the tree's descriptor
  int bottom;               // the first layer this pass hashes
  int tile_log;             // its CTAs own 2^min(tile_log, bottom) nodes of it (10 on the card)
  unsigned long long state;  // with a channel: the channel state (CH_WORDS words), else 0
  unsigned long long slot;   // with a channel: the layer's record slot (12 words), else 0
};

__host__ __device__ __forceinline__ int merkle_tile(const MerklePass& p) {
  return p.bottom < p.tile_log ? p.bottom : p.tile_log;
}

__host__ __device__ __forceinline__ long long merkle_ctas(const MerklePass& p) {
  return 1LL << (p.bottom - merkle_tile(p));
}

// Shared memory of a CTA (words): the tile's first layer, 2^t digests, and
// the layer above it, 2^(t-1); later layers alternate between the two.  A
// pair of siblings takes 17 words (16 and one of padding), so the 16 loads
// of a parent's children hit 32 distinct banks across a warp.
__host__ __device__ __forceinline__ long long merkle_pairs(int n) { return n > 1 ? n / 2 : 1; }

__host__ __device__ __forceinline__ long long merkle_smem_words(int t) {
  return 17 * (merkle_pairs(1 << t) + merkle_pairs(1 << (t > 0 ? t - 1 : 0)));
}

__host__ __device__ __forceinline__ long long merkle_slot(long long n) { return 17 * (n >> 1) + 8 * (n & 1); }

// Eight words at a 16-byte aligned address, as two 16-byte accesses.
struct alignas(16) mk_u32x4 {
  uint32_t v[4];
};

// The digest of node i of the layer whose descriptor row is `row`; `kids`
// holds its children's 16 words unless it is on the bottom layer.
__device__ __forceinline__ void merkle_node(const uint32_t (&kids)[16], bool has_kids, const long long* row,
                                            long long i, uint32_t h[8]) {
  const uint32_t* col = reinterpret_cast<const uint32_t*>(row[1]);
  const int k = (int)row[2];
  const long long s0 = row[3], s1 = row[4];
  const int n_kids = has_kids ? 16 : 0;
  const int len = n_kids + k;
  const int n_blocks = len > 0 ? (len + 15) / 16 : 1;
  blake2s_init(h);
  for (int blk = 0; blk < n_blocks; blk++) {
    uint32_t m[16];
    if (blk == 0 && has_kids) {  // the children fill the first block
#pragma unroll
      for (int w = 0; w < 16; w++) m[w] = kids[w];
    } else {
#pragma unroll
      for (int w = 0; w < 16; w++) {
        const int c = blk * 16 + w - n_kids;
        m[w] = c < k ? col[(long long)c * s0 + i * s1] : 0u;
      }
    }
    const bool last = blk == n_blocks - 1;
    blake2s_compress(h, m, last ? (uint32_t)(4 * len) : (uint32_t)(64 * (blk + 1)), last);
  }
}

template <class Block, bool Channel = false>
__device__ __forceinline__ void merkle_cta(const Block& b, const MerklePass& p, long long cta, uint32_t* sm) {
  const long long* desc = reinterpret_cast<const long long*>(p.desc);
  const int L = (int)desc[0];
  const int t = merkle_tile(p);
  uint32_t* keep[2] = {sm, sm + 17 * merkle_pairs(1 << t)};
  uint32_t chan[CH_WORDS];  // thread 0's copy of the channel state
  if constexpr (Channel) {
    if (b.tid() == 0)
      for (int w = 0; w < CH_ALPHA; w++) chan[w] = reinterpret_cast<const uint32_t*>(p.state)[w];
  }
  for (int j = 0; j <= t; j++) {
    const int l = p.bottom - j;
    const long long* row = desc + 1 + 5 * l;
    uint32_t* layer = reinterpret_cast<uint32_t*>(row[0]);
    const long long base = cta << (t - j);
    const int n = 1 << (t - j);
    const uint32_t* below = keep[(j - 1) & 1];
    const mk_u32x4* below_dev =
        j == 0 && l < L ? reinterpret_cast<const mk_u32x4*>(desc[1 + 5 * (l + 1)]) + 4 * base : nullptr;
    uint32_t* out = keep[j & 1];
    for (int i = b.tid(); i < n; i += b.threads()) {
      uint32_t kids[16];
      if (below_dev) {
#pragma unroll
        for (int q = 0; q < 4; q++) {
          const mk_u32x4 v = below_dev[4 * i + q];
#pragma unroll
          for (int e = 0; e < 4; e++) kids[4 * q + e] = v.v[e];
        }
      } else if (j > 0) {
#pragma unroll
        for (int w = 0; w < 16; w++) kids[w] = below[17 * i + w];
      }
      uint32_t h[8];
      merkle_node(kids, j > 0 || below_dev, row, base + i, h);
      mk_u32x4* dst = reinterpret_cast<mk_u32x4*>(layer + 8 * (base + i));
      dst[0] = {{h[0], h[1], h[2], h[3]}};
      dst[1] = {{h[4], h[5], h[6], h[7]}};
      if (j < t) {
#pragma unroll
        for (int w = 0; w < 8; w++) out[merkle_slot(i) + w] = h[w];
      }
      if constexpr (Channel) {
        if (l == 0) {  // the root (thread 0's): K8's step on it, still in registers
          mix_root(chan, h);
          draw_felt(chan);
          uint32_t* state = reinterpret_cast<uint32_t*>(p.state);
          uint32_t* slot = reinterpret_cast<uint32_t*>(p.slot);
          for (int w = 0; w < CH_WORDS; w++) state[w] = chan[w];
          for (int w = 0; w < 8; w++) slot[w] = h[w];
          for (int k = 0; k < 4; k++) slot[8 + k] = chan[CH_ALPHA + k];
        }
      }
    }
    b.sync();
  }
}

}  // namespace lum
