"""The circuit settings a statement fixes, worked out from the reference's
own forward pass, and their flat wire bytes (magic ``LMSF``, version 2:
for each of sin, exp2, log2 a presence byte, then the table's log size,
its ranges as (lo, hi) int64 pairs and its output table as int64; then
the range check's presence and bits; little-endian throughout)."""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

from . import fixed as fx

LUT_KINDS = ("sin", "exp2", "log2")
LUT_FNS = {"exp2": np.exp2, "sin": np.sin, "log2": lambda x: np.log2(np.maximum(x, 1e-300))}
RANGE_CHECK_BITS = 8


@dataclass
class Lut:
    ranges: List[Tuple[int, int]]

    @property
    def count(self) -> int:
        return sum(hi - lo + 1 for lo, hi in self.ranges)

    @property
    def log_size(self) -> int:
        return fx.log_size(self.count)

    def outputs(self, kind: str) -> np.ndarray:
        values = np.concatenate([np.arange(lo, hi + 1, dtype=np.int64) for lo, hi in self.ranges])
        return fx.from_float(LUT_FNS[kind](fx.to_float(values)))


def luts(tape: fx.Tape) -> Dict[str, Lut]:
    return {kind: Lut(fx.coalesce([fx.lut_range(s) for s in srcs])) for kind, srcs in tape.lut_sources.items() if srcs}


def flat_bytes(tape: fx.Tape) -> bytes:
    tables = luts(tape)
    parts = [b"LMSF", struct.pack("<I", 2)]
    for kind in LUT_KINDS:
        lut = tables.get(kind)
        parts.append(struct.pack("<B", lut is not None))
        if lut is not None:
            parts.append(struct.pack("<II", lut.log_size, len(lut.ranges)))
            parts.extend(struct.pack("<qq", lo, hi) for lo, hi in lut.ranges)
            out = lut.outputs(kind)
            parts.append(struct.pack("<I", len(out)))
            parts.append(out.astype("<i8").tobytes())
    parts.append(struct.pack("<B", tape.range_check))
    if tape.range_check:
        parts.append(struct.pack("<I", RANGE_CHECK_BITS))
    return b"".join(parts)
