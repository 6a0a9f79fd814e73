"""Proof and settings serialisation.

`proof_to_flat_bytes` / `settings_to_flat_bytes` give the flat wire format
(".lmv" proof / ".lms" settings): a deterministic little-endian layout that
the native verifier (native/verifier.cpp) parses, byte for byte the
reference package's.
"""

from __future__ import annotations

import struct
from typing import List

import numpy as np

from .errors import SerializationError


_FLAT_MAGIC_PROOF = b"LMVF"
_FLAT_MAGIC_SETTINGS = b"LMSF"
# Settings v2: each LUT carries its normative output table (i64 raw fixed
# f(x) per enumerated input) -- verifiers materialize preprocessed columns
# from these bytes instead of recomputing transcendentals (PROTOCOL §5).
# v1 (ranges only) is still parsed by all verifiers as the legacy path.
_FLAT_VERSION_SETTINGS = 2
_FLAT_VERSION_PROOF = 2  # v2: FRI config gained folds_per_layer (multi-fold layers)


class _W:
    def __init__(self):
        self.parts: List[bytes] = []

    def u8(self, v):
        self.parts.append(struct.pack("<B", int(v)))

    def u32(self, v):
        self.parts.append(struct.pack("<I", int(v)))

    def u64(self, v):
        self.parts.append(struct.pack("<Q", int(v)))

    def i64(self, v):
        self.parts.append(struct.pack("<q", int(v)))

    def u32s(self, arr):
        a = np.asarray(arr, dtype="<u4").reshape(-1)
        self.u32(len(a))
        self.parts.append(a.tobytes())

    def words(self, arr, n):
        """Fixed-size word group (e.g. a digest or a qm31), no length."""
        a = np.asarray(arr, dtype="<u4").reshape(-1)
        if len(a) != n:
            raise SerializationError(f"expected {n} words, got {len(a)}")
        self.parts.append(a.tobytes())

    def bytes(self) -> bytes:
        return b"".join(self.parts)


def settings_to_flat_bytes(settings) -> bytes:
    luts = [getattr(settings.lookups, k) for k in ("sin", "exp2", "log2")]
    # v2 iff every present LUT ships its normative output table; a legacy
    # settings object (no outputs) still serializes as v1.
    v2 = all(l is None or l.outputs is not None for l in luts)
    w = _W()
    w.parts.append(_FLAT_MAGIC_SETTINGS)
    w.u32(_FLAT_VERSION_SETTINGS if v2 else 1)
    for layout in luts:
        w.u8(1 if layout is not None else 0)
        if layout is not None:
            w.u32(layout.log_size)
            w.u32(len(layout.ranges))
            for r in layout.ranges:
                w.i64(r.lo)
                w.i64(r.hi)
            if v2:
                a = np.asarray(layout.outputs, dtype="<i8").reshape(-1)
                w.u32(len(a))
                w.parts.append(a.tobytes())
    rc = settings.lookups.range_check_bits
    w.u8(1 if rc else 0)
    if rc:
        w.u32(rc)
    return w.bytes()


def proof_to_flat_bytes(proof) -> bytes:
    from .air.components import ALL_COMPONENTS

    w = _W()
    w.parts.append(_FLAT_MAGIC_PROOF)
    w.u32(_FLAT_VERSION_PROOF)
    # config
    w.u32(proof.config.pow_bits)
    w.u32(proof.config.fri.log_blowup_factor)
    w.u32(proof.config.fri.log_last_layer_degree_bound)
    w.u32(proof.config.fri.n_queries)
    w.u32(proof.config.fri.folds_per_layer)
    # claim: (component index, log_size) in canonical order
    present = [
        (i, c.name) for i, c in enumerate(ALL_COMPONENTS) if c.name in proof.claim.log_sizes
    ]
    w.u32(len(present))
    for i, name in present:
        w.u32(i)
        w.u32(proof.claim.log_sizes[name])
    # interaction claimed sums, same order
    for _, name in present:
        w.words(proof.interaction_claim.sums[name], 4)
    # tree roots
    w.u32(len(proof.roots))
    for r in proof.roots:
        w.words(r, 8)
    # sampled values
    p = proof.pcs_proof
    w.u32(len(p.sampled_values))
    for tree_vals in p.sampled_values:
        w.u32(len(tree_vals))
        for col_vals in tree_vals:
            w.u32(len(col_vals))
            for v in col_vals:
                w.words(v, 4)
    w.u64(p.pow_nonce)
    # tree openings
    w.u32(len(p.tree_queried_values))
    for arrays in p.tree_queried_values:
        w.u32(len(arrays))
        for a in arrays:
            w.u32s(a)
    w.u32(len(p.tree_witnesses))
    for digests in p.tree_witnesses:
        w.u32(len(digests))
        w.words(digests, 8 * len(digests))
    # FRI
    f = p.fri_proof
    w.u32(len(f.layer_roots))
    for r in f.layer_roots:
        w.words(r, 8)
    w.u32(len(f.layer_queried_values))
    for arrays in f.layer_queried_values:
        w.u32(len(arrays))
        for a in arrays:
            w.u32s(a)
    w.u32(len(f.layer_witnesses))
    for digests in f.layer_witnesses:
        w.u32(len(digests))
        w.words(digests, 8 * len(digests))
    coeffs = np.asarray(f.last_layer_coeffs, dtype=np.uint32)
    w.u32(coeffs.shape[0])
    w.words(coeffs, 4 * coeffs.shape[0])
    return w.bytes()


