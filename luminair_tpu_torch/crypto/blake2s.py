"""Blake2s-256 of uint32 word messages, bit-identical to hashlib.blake2s.

`hash_words_plain` hashes a batch of equal-length messages (the
little-endian bytes of their words) in int64 torch: it keeps the 4x4 state
as four (4, batch) rows, applies G to whole rows (column step, then the
diagonal step through row rolls) and masks with 0xFFFFFFFF after every add
and rotate.  It is the plain twin of the kernels that hash on the card:
the Merkle tree (K2), the channel (K8) and the proof-of-work search (K10).
"""

from __future__ import annotations

import torch

from .. import fields as f

IV = [0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A, 0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19]

SIGMA = [
    [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15],
    [14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3],
    [11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4],
    [7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8],
    [9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13],
    [2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9],
    [12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11],
    [13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10],
    [6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5],
    [10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0],
]

MASK = 0xFFFFFFFF


def _rotr(x, n: int):
    return ((x >> n) | (x << (32 - n))) & MASK


def _g_rows(a, b, c, d, x, y):
    a = (a + b + x) & MASK
    d = _rotr(d ^ a, 16)
    c = (c + d) & MASK
    b = _rotr(b ^ c, 12)
    a = (a + b + y) & MASK
    d = _rotr(d ^ a, 8)
    c = (c + d) & MASK
    b = _rotr(b ^ c, 7)
    return a, b, c, d


def _compress(h, block, t: int, last: bool):
    """h: (8, batch) int64 words; block: (16, batch); t: byte counter."""
    batch = h.shape[1]
    dev = h.device
    a, b = h[0:4], h[4:8]
    c = torch.tensor(IV[0:4], dtype=f.I64, device=dev)[:, None].expand(4, batch)
    d_init = list(IV[4:8])
    d_init[0] ^= t & MASK
    d_init[1] ^= (t >> 32) & MASK
    if last:
        d_init[2] ^= MASK
    d = torch.tensor(d_init, dtype=f.I64, device=dev)[:, None].expand(4, batch)
    for s in SIGMA:
        a, b, c, d = _g_rows(a, b, c, d, block[s[0:8:2]], block[s[1:8:2]])
        b, c, d = b.roll(-1, 0), c.roll(-2, 0), d.roll(-3, 0)
        a, b, c, d = _g_rows(a, b, c, d, block[s[8:16:2]], block[s[9:16:2]])
        b, c, d = b.roll(1, 0), c.roll(2, 0), d.roll(3, 0)
    return h ^ torch.cat([a, b]) ^ torch.cat([c, d])


def hash_words_plain(words: torch.Tensor) -> torch.Tensor:
    """(..., L) int32 words -> (..., 8) int32 digests, in int64 torch."""
    L = words.shape[-1]
    batch = words.shape[:-1]
    w = f.to_u32_i64(words.reshape(-1, L)).t()  # (L, n)
    n = w.shape[1]
    n_blocks = max(1, -(-L // 16))
    h0 = list(IV)
    h0[0] ^= 0x01010000 ^ 32
    h = torch.tensor(h0, dtype=f.I64, device=words.device)[:, None].expand(8, n)
    for blk in range(n_blocks):
        block = w[blk * 16 : blk * 16 + 16]
        if block.shape[0] < 16:
            pad = torch.zeros((16 - block.shape[0], n), dtype=f.I64, device=words.device)
            block = torch.cat([block, pad])
        last = blk == n_blocks - 1
        h = _compress(h, block, 4 * L if last else (blk + 1) * 64, last)
    return f.to_i32(h.t()).contiguous().reshape(batch + (8,))

