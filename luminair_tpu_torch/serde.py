"""Artifact serialisation: proofs, PIEs and settings.

Two forms, byte for byte the reference package's (luminair_tpu/serde.py):

  * the message container (`write_msg_file` / `read_msg_file`): an .npz
    (a zip of little-endian .npy arrays) with a JSON manifest; a payload's
    arrays are numbered in the order `_encode` walks it, so every array is
    uint32 and every list in the reference's order.  Proofs (`proof_to_file`,
    or JSON with `proof_to_json_file`), PIEs (`pie_to_file`) and settings
    (`CircuitSettings.to_bin_file`) use it;
  * the flat wire format (".lmv" proof / ".lms" settings): a deterministic
    little-endian layout that the native verifier (native/verifier.cpp)
    parses.
"""

from __future__ import annotations

import json
import struct
from typing import Any, List, Tuple

import numpy as np

from .errors import SerializationError


def _encode(obj, arrays: List[np.ndarray]):
    if isinstance(obj, np.ndarray):
        arrays.append(obj)
        return {"$a": len(arrays) - 1}
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, dict):
        return {"$d": {str(k): _encode(v, arrays) for k, v in obj.items()}}
    if isinstance(obj, (list, tuple)):
        return {"$l": [_encode(v, arrays) for v in obj]}
    if obj is None or isinstance(obj, (int, float, str, bool)):
        return obj
    raise SerializationError(f"cannot encode {type(obj)}")


def _decode(obj, arrays):
    if isinstance(obj, dict):
        if "$a" in obj:
            return arrays[f"arr_{obj['$a']}"]
        if "$d" in obj:
            return {k: _decode(v, arrays) for k, v in obj["$d"].items()}
        if "$l" in obj:
            return [_decode(v, arrays) for v in obj["$l"]]
    return obj


def write_msg_file(path: str, kind: str, payload):
    arrays: List[np.ndarray] = []
    manifest = json.dumps({"kind": kind, "payload": _encode(payload, arrays)})
    named = {f"arr_{i}": a for i, a in enumerate(arrays)}
    with open(path, "wb") as fh:  # the exact file name (savez would append .npz)
        np.savez_compressed(fh, manifest=np.frombuffer(manifest.encode(), dtype=np.uint8), **named)


def read_msg_file(path: str) -> Tuple[str, Any]:
    with np.load(path) as z:
        manifest = json.loads(bytes(z["manifest"]).decode())
        return manifest["kind"], _decode(manifest["payload"], z)


def _u32(a) -> np.ndarray:
    return np.asarray(a, dtype=np.uint32)


def _digests(a) -> List[np.ndarray]:
    """A witness ((n, 8) words or n digests) as the list of (8,) uint32
    digests the payload holds."""
    return list(_u32(a).reshape(-1, 8))


def _witness(items) -> np.ndarray:
    """A payload's digest list -> (n, 8) uint32, the prover's form."""
    try:
        return _u32(items).reshape(-1, 8)
    except ValueError as e:
        raise SerializationError(f"a witness holds a digest that is not 8 words: {e}") from None


def proof_to_payload(proof) -> dict:
    """The proof as the reference's payload: dicts, lists and uint32 arrays."""
    p = proof.pcs_proof
    fp = p.fri_proof
    return {
        "claim": proof.claim.to_dict(),
        "interaction_claim": proof.interaction_claim.to_dict(),
        "roots": [_u32(r) for r in proof.roots],
        "config": proof.config.to_dict(),
        "pcs": {
            "sampled_values": [[[_u32(v) for v in col] for col in tree] for tree in p.sampled_values],
            "pow_nonce": int(p.pow_nonce),
            "tree_queried_values": [[_u32(a) for a in tree] for tree in p.tree_queried_values],
            "tree_witnesses": [_digests(w) for w in p.tree_witnesses],
            "fri": {
                "layer_roots": [_u32(r) for r in fp.layer_roots],
                "layer_queried_values": [[_u32(a) for a in layer] for layer in fp.layer_queried_values],
                "layer_witnesses": [_digests(w) for w in fp.layer_witnesses],
                "last_layer_coeffs": _u32(fp.last_layer_coeffs),
                "pow_nonce": int(fp.pow_nonce),
            },
        },
    }


def proof_from_payload(payload):
    from .air.claim import LuminairClaim, LuminairInteractionClaim
    from .pcs.config import PcsConfig
    from .pcs.fri import FriProof
    from .pcs.scheme import PcsProof
    from .prover import LuminairProof

    pcs, fri = payload["pcs"], payload["pcs"]["fri"]
    fri_proof = FriProof(
        layer_roots=[_u32(r) for r in fri["layer_roots"]],
        layer_queried_values=[[_u32(a) for a in layer] for layer in fri["layer_queried_values"]],
        layer_witnesses=[_witness(w) for w in fri["layer_witnesses"]],
        last_layer_coeffs=_u32(fri["last_layer_coeffs"]),
        pow_nonce=int(fri["pow_nonce"]),
    )
    return LuminairProof(
        claim=LuminairClaim.from_dict(payload["claim"]),
        interaction_claim=LuminairInteractionClaim.from_dict(payload["interaction_claim"]),
        roots=[_u32(r) for r in payload["roots"]],
        pcs_proof=PcsProof(
            sampled_values=[[[_u32(v) for v in col] for col in tree] for tree in pcs["sampled_values"]],
            fri_proof=fri_proof,
            pow_nonce=int(pcs["pow_nonce"]),
            tree_queried_values=[[_u32(a) for a in tree] for tree in pcs["tree_queried_values"]],
            tree_witnesses=[_witness(w) for w in pcs["tree_witnesses"]],
        ),
        config=PcsConfig.from_dict(payload["config"]),
    )


def proof_to_file(proof, path: str):
    write_msg_file(path, "proof", proof_to_payload(proof))


def proof_from_file(path: str):
    kind, payload = read_msg_file(path)
    if kind != "proof":
        raise SerializationError(f"expected proof file, got {kind}")
    return proof_from_payload(payload)


def proof_to_json_file(proof, path: str):
    arrays: List[np.ndarray] = []
    enc = _encode(proof_to_payload(proof), arrays)
    with open(path, "w") as fh:
        json.dump({"payload": enc, "arrays": [a.tolist() for a in arrays]}, fh)


def proof_from_json_file(path: str):
    with open(path) as fh:
        d = json.load(fh)
    arrays = {f"arr_{i}": _u32(a) for i, a in enumerate(d["arrays"])}
    return proof_from_payload(_decode(d["payload"], arrays))


def pie_to_file(pie, path: str):
    """The PIE in its host form (uint32 columns, n_rows long; a PIE on a
    device is downloaded)."""
    write_msg_file(
        path,
        "pie",
        {
            "tables": {name: {"columns": t.host_columns()} for name, t in pie.trace_tables.items()},
            "metadata": pie.metadata.to_dict(),
        },
    )


def pie_from_file(path: str):
    """A host PIE (uint32 numpy columns); `prove` uploads it."""
    from .air.pie import LuminairPie, Metadata, TraceTable

    kind, payload = read_msg_file(path)
    if kind != "pie":
        raise SerializationError(f"expected pie file, got {kind}")
    tables = {
        name: TraceTable(name, {k: _u32(v) for k, v in d["columns"].items()})
        for name, d in payload["tables"].items()
    }
    return LuminairPie(tables, Metadata.from_dict(payload["metadata"]))


# ---------------------------------------------------------------------------
# The flat wire format.

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


def proof_to_flat_file(proof, path: str):
    with open(path, "wb") as fh:
        fh.write(proof_to_flat_bytes(proof))


def settings_to_flat_file(settings, path: str):
    with open(path, "wb") as fh:
        fh.write(settings_to_flat_bytes(settings))
