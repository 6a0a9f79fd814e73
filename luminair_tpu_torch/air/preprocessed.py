"""Preprocessed (committed-ahead) columns: lookup tables and is_first flags.

Mirrors the reference's crates/air/src/preprocessed.rs:
  * Range / LookupLayout with binary-searched find_index
    (preprocessed.rs:33-115) -- here find_index is vectorized with
    np.searchsorted over range starts (one gather per op instead of a
    scalar loop per element);
  * Sin/Exp2/Log2 LUTs: 2 columns each, (input, f(input)) over the
    coalesced ranges, zero-padded to 2^log_size (preprocessed.rs:313-554);
  * RangeCheck enumeration column 0..2^bits (preprocessed.rs:210-305);
  * IsFirst columns (one per trace log-size) supporting the LogUp boundary
    constraint -- this framework's addition (stwo ships the same column
    type in its constraint framework).

The PreProcessedTrace fixes the global column order (ids sorted, sizes
descending) shared by prover and verifier; the verifier rebuilds all
columns from CircuitSettings and re-commits tree 0 itself, exactly like the
reference verifier (crates/verifiers/rust/src/verifier.rs:33-34).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from .. import fields as f
from .. import fixed

MIN_LOG_SIZE = 4  # padded tables have at least 16 rows (reference
# crates/air/src/utils.rs:22-27, calculate_log_size with N_LANES = 16)


def calculate_log_size(n_rows: int) -> int:
    return max(MIN_LOG_SIZE, int(math.ceil(math.log2(max(1, n_rows)))))


@dataclass
class Range:
    lo: int  # raw fixed-point values, inclusive
    hi: int

    def to_dict(self):
        return {"lo": int(self.lo), "hi": int(self.hi)}

    @staticmethod
    def from_dict(d):
        return Range(int(d["lo"]), int(d["hi"]))


@dataclass
class LookupLayout:
    """LUT layout + (optionally) the NORMATIVE output table.

    `outputs` holds the raw fixed-point f(x) value per enumerated input (in
    `all_values()` order).  When present, those bytes ARE the protocol: the
    prover commits them, the witness reads op outputs from them, and every
    verifier materializes the preprocessed column from them (after a
    tolerance check against float64 f).  Verifiers then agree on bytes,
    not on the rounding of their libm.
    """

    ranges: List[Range]
    log_size: int = 0
    outputs: Optional[np.ndarray] = None  # int64 raw fixed, len == value_count()

    def __post_init__(self):
        if self.log_size == 0:
            self.log_size = calculate_log_size(self.value_count())
        if self.outputs is not None:
            self.outputs = np.asarray(self.outputs, dtype=np.int64)
            assert len(self.outputs) == self.value_count()

    def value_count(self) -> int:
        return sum(r.hi - r.lo + 1 for r in self.ranges)

    def packed(self):
        """(lo, hi, start) int64 arrays, one entry per range in ascending
        order: start is the range's first position in the enumeration."""
        los = np.array([r.lo for r in self.ranges], dtype=np.int64)
        his = np.array([r.hi for r in self.ranges], dtype=np.int64)
        starts = np.concatenate([[0], np.cumsum(his - los + 1)])[:-1].astype(np.int64)
        return los, his, starts

    def find_index(self, targets):
        """Position of each raw value in the enumeration of all range
        values; -1 if out of range (one vectorised searchsorted).  An int64
        tensor gives a tensor on its device."""
        if isinstance(targets, torch.Tensor):
            los, his, starts = (f.to_device(torch.from_numpy(a), targets.device) for a in self.packed())
            return find_index_packed(targets, los, his, starts)
        targets = np.asarray(targets, dtype=np.int64)
        los, his, starts = self.packed()
        idx = np.searchsorted(los, targets, side="right") - 1
        idx_c = np.clip(idx, 0, len(los) - 1)
        in_range = (idx >= 0) & (targets <= his[idx_c]) & (targets >= los[idx_c])
        out = starts[idx_c] + (targets - los[idx_c])
        return np.where(in_range, out, -1)

    def all_values(self) -> np.ndarray:
        return np.concatenate(
            [np.arange(r.lo, r.hi + 1, dtype=np.int64) for r in self.ranges]
        )

    def to_dict(self):
        d = {"ranges": [r.to_dict() for r in self.ranges], "log_size": self.log_size}
        if self.outputs is not None:
            import base64

            d["outputs_b64"] = base64.b64encode(
                np.asarray(self.outputs, dtype="<i8").tobytes()
            ).decode("ascii")
        return d

    @staticmethod
    def from_dict(d):
        outputs = None
        if d.get("outputs_b64"):
            import base64

            outputs = np.frombuffer(
                base64.b64decode(d["outputs_b64"]), dtype="<i8"
            ).astype(np.int64)
        return LookupLayout(
            [Range.from_dict(r) for r in d["ranges"]],
            log_size=d["log_size"],
            outputs=outputs,
        )


def find_index_packed(targets: torch.Tensor, los: torch.Tensor, his: torch.Tensor,
                      starts: torch.Tensor) -> torch.Tensor:
    """`LookupLayout.find_index` over the packed ranges, on tensors."""
    idx = torch.searchsorted(los, targets, right=True) - 1
    idx_c = idx.clamp(0, len(los) - 1)
    lo, hi = los[idx_c], his[idx_c]
    in_range = (idx >= 0) & (targets <= hi) & (targets >= lo)
    return torch.where(in_range, starts[idx_c] + (targets - lo), torch.full_like(targets, -1))


def coalesce_ranges(ranges: List[Range]) -> List[Range]:
    """Merge overlapping/adjacent ranges (reference graph.rs:665-691)."""
    if not ranges:
        return []
    ranges = sorted(ranges, key=lambda r: r.lo)
    out = [Range(ranges[0].lo, ranges[0].hi)]
    for r in ranges[1:]:
        if r.lo <= out[-1].hi + 1:
            out[-1].hi = max(out[-1].hi, r.hi)
        else:
            out.append(Range(r.lo, r.hi))
    return out


#: f of each LUT op, in float64 (the host computes every LUT value with it).
LUT_FNS = {
    "sin": np.sin,
    "exp2": np.exp2,
    "log2": lambda x: np.log2(np.maximum(x, 1e-300)),
}


_SAFE_MAX = float(1 << 62)
# Tolerance for verifying a shipped LUT table against float64 f(x), in raw
# fixed units: two steps of absolute slack (0.5 from round-to-fixed plus a
# full step of generation noise) and a 2^-48 relative term that absorbs
# cross-libm last-ulp divergence (at most 2 ulps between numpy, glibc and
# JS Math on the sin/exp2/log2 grids; 2^-48 ~ 16 ulps).  Normative: host
# float64 only.
_LUT_TOL_ABS = 2.0
_LUT_TOL_REL = 2.0 ** -48


def lut_reference_outputs(kind: str, values: np.ndarray) -> np.ndarray:
    """The RECOMMENDED generation procedure for the normative output table:
    float64 f over the fixed grid, round-half-even to fixed; this is what
    gen_circuit_settings ships."""
    return fixed.from_float(LUT_FNS[kind](fixed.to_float(values)))


def validate_lut_outputs(kind: str, values: np.ndarray, outputs: np.ndarray):
    """Check a shipped output table approximates f within tolerance, in
    float64 numpy on the host.  Verifiers run this before trusting settings
    bytes: the table is part of the public statement, and the check bounds
    how far a malicious prover can bend "sin"/"exp2"/"log2" (relative error
    <= ~2^-48 plus one fixed step).  Returns (ok, n_bad)."""
    outputs = np.asarray(outputs, dtype=np.int64)
    if len(outputs) != len(values):
        return False, len(values)
    ys = LUT_FNS[kind](fixed.to_float(values)) * float(fixed.SCALE_FACTOR)
    ys = np.nan_to_num(ys, nan=0.0, posinf=_SAFE_MAX, neginf=-_SAFE_MAX)
    ys = np.clip(ys, -_SAFE_MAX, _SAFE_MAX)
    tol = _LUT_TOL_ABS + np.abs(ys) * _LUT_TOL_REL
    bad = np.abs(outputs.astype(np.float64) - ys) > tol
    return not bool(bad.any()), int(bad.sum())


def finalize_lookups(lookups) -> None:
    """Fill the normative `outputs` table on every present LUT layout
    (called by gen_circuit_settings after range discovery)."""
    for kind in LUT_FNS:
        layout = getattr(lookups, kind, None)
        if layout is not None and layout.outputs is None:
            layout.outputs = lut_reference_outputs(kind, layout.all_values())


class LutPreProcessed:
    """A 2-column (input, f(input)) lookup table.

    Output column comes from the layout's normative `outputs` bytes when
    present (the protocol path); the float recompute fallback only serves
    legacy settings objects without shipped tables."""

    def __init__(self, kind: str, layout: LookupLayout):
        assert kind in LUT_FNS
        self.kind = kind
        self.layout = layout

    @property
    def log_size(self) -> int:
        return self.layout.log_size

    def ids(self):
        return [f"{self.kind}_lut_0", f"{self.kind}_lut_1"]

    def columns(self) -> List[np.ndarray]:
        vals, outs = self.table_values()
        n = 1 << self.layout.log_size
        col0 = np.zeros(n, dtype=np.uint32)
        col1 = np.zeros(n, dtype=np.uint32)
        col0[: len(vals)] = fixed.to_m31(vals)
        col1[: len(vals)] = fixed.to_m31(outs)
        return [col0, col1]

    def table_values(self):
        """(raw_inputs, raw_outputs) as int64 fixed values (unpadded)."""
        vals = self.layout.all_values()
        if self.layout.outputs is not None:
            return vals, self.layout.outputs
        return vals, lut_reference_outputs(self.kind, vals)


class RangeCheckPreProcessed:
    """Enumeration column 0..2^bits (8-bit used by less_than)."""

    def __init__(self, bits: int):
        self.bits = bits
        self.log_size = bits

    def ids(self):
        return [f"range_check_{self.bits}_column_0"]

    def columns(self):
        return [np.arange(1 << self.bits, dtype=np.uint32)]


class IsFirstPreProcessed:
    def __init__(self, log_size: int):
        self.log_size = log_size

    def ids(self):
        return [f"is_first_{self.log_size}"]

    def columns(self):
        col = np.zeros(1 << self.log_size, dtype=np.uint32)
        col[0] = 1
        return [col]


class PreProcessedTrace:
    """Deterministic ordered collection of preprocessed columns.

    Order: is_first columns (log desc), then LUTs (sin, exp2, log2 present
    ones), then range checks.  Both sides build this from
    (CircuitSettings, claim log-sizes)."""

    def __init__(self, is_first_logs: List[int], luts: List[LutPreProcessed], range_checks: List[RangeCheckPreProcessed]):
        self.is_first_logs = sorted(set(is_first_logs), reverse=True)
        self.luts = luts
        self.range_checks = range_checks

    def entries(self):
        out = []
        for log in self.is_first_logs:
            out.append(IsFirstPreProcessed(log))
        out.extend(self.luts)
        out.extend(self.range_checks)
        return out

    def ids(self) -> List[str]:
        return [i for e in self.entries() for i in e.ids()]

    def columns(self) -> List[np.ndarray]:
        return [c for e in self.entries() for c in e.columns()]

    def logs(self) -> List[int]:
        out = []
        for e in self.entries():
            for _ in e.ids():
                out.append(e.log_size)
        return out
