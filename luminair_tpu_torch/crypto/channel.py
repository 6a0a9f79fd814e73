"""Blake2s Fiat-Shamir channel, on the host (hashlib).

State = 32-byte digest + per-digest draw counter.
  mix(data):   digest = blake2s(digest || data); counter = 0
  draw block:  blake2s(digest || LE64(counter)); counter += 1
Field elements are drawn by rejection-sampling LE32 words w < 2*P (then
reduced mod P).  The transcript schedule is the reference package's
(crypto/channel.py there); draws are numpy uint32 arrays.
"""

from __future__ import annotations

import hashlib

import numpy as np

from ..fields import P as _P


class Blake2sChannel:
    def __init__(self):
        self.digest = b"\x00" * 32
        self._counter = 0

    # -- mixing -----------------------------------------------------------

    def mix_bytes(self, data: bytes):
        self.digest = hashlib.blake2s(self.digest + data).digest()
        self._counter = 0

    def mix_u32s(self, values):
        self.mix_bytes(np.asarray(values, dtype="<u4").tobytes())

    def mix_u64(self, value: int):
        self.mix_bytes(int(value).to_bytes(8, "little"))

    def mix_root(self, root_words):
        """Mix a Merkle root given as (8,) uint32 words."""
        self.mix_bytes(np.asarray(root_words, dtype="<u4").tobytes())

    def mix_felts(self, felts):
        """Mix QM31 felts: (..., 4) uint32 array."""
        self.mix_bytes(np.asarray(felts, dtype="<u4").reshape(-1).tobytes())

    # -- drawing ----------------------------------------------------------

    def _draw_block(self) -> bytes:
        out = hashlib.blake2s(self.digest + self._counter.to_bytes(8, "little")).digest()
        self._counter += 1
        return out

    def draw_base_felts(self, n: int) -> np.ndarray:
        """n uniform M31 elements, rejection-sampled."""
        out = []
        while len(out) < n:
            for w in np.frombuffer(self._draw_block(), dtype="<u4"):
                w = int(w)
                if w < 2 * _P:  # reject 0xFFFFFFFE / 0xFFFFFFFF
                    out.append(w % _P)
                    if len(out) == n:
                        break
        return np.array(out, dtype=np.uint32)

    def draw_felt(self) -> np.ndarray:
        """One uniform QM31 element, shape (4,) uint32."""
        return self.draw_base_felts(4)

    def draw_queries(self, n: int, log_domain_size: int) -> np.ndarray:
        """n query positions in [0, 2^log_domain_size), sorted and deduped."""
        mask = (1 << log_domain_size) - 1
        picked = []
        while len(picked) < n:
            for w in np.frombuffer(self._draw_block(), dtype="<u4"):
                picked.append(int(w) & mask)
                if len(picked) == n:
                    break
        return np.unique(np.array(picked, dtype=np.int64))

    # -- proof of work ----------------------------------------------------

    def check_pow_nonce(self, bits: int, nonce: int) -> bool:
        h = hashlib.blake2s(self.digest + int(nonce).to_bytes(8, "little")).digest()
        v = int.from_bytes(h[:8], "little")
        return bits == 0 or (v & ((1 << bits) - 1)) == 0

    def grind_pow(self, bits: int) -> int:
        """Smallest nonce whose PoW hash has `bits` low zero bits (expected
        2^bits hashlib calls; a device nonce search is later work)."""
        nonce = 0
        while not self.check_pow_nonce(bits, nonce):
            nonce += 1
        return nonce
