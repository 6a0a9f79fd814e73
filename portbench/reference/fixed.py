"""Fixed-point arithmetic of the proved graphs, in plain numpy.

A value is an int64 ``v`` standing for ``v / 2^12``.  These are the
semantics the prover's statement fixes (LuminAIR's fixed-point ops over
M31): products and reciprocals round toward zero, encodings round to
nearest.  Written for the benchmark's reference; it imports nothing of
the program.
"""

from __future__ import annotations

import math
from collections import defaultdict

import numpy as np

SCALE_BITS = 12
SCALE = np.int64(1 << SCALE_BITS)
_SAFE_MAX = float(1 << 62)
RANGE_MARGIN = 0.10  # a LUT's range is its source's min and max, widened by a tenth each way
MIN_LOG_SIZE = 4  # a table pads to at least 16 rows


def from_float(x) -> np.ndarray:
    """Round-half-even encoding; beyond +-2^62 saturates."""
    scaled = np.round(np.asarray(x, dtype=np.float64) * float(SCALE))
    scaled = np.nan_to_num(scaled, nan=0.0, posinf=_SAFE_MAX, neginf=-_SAFE_MAX)
    return np.clip(scaled, -_SAFE_MAX, _SAFE_MAX).astype(np.int64)


def to_float(v) -> np.ndarray:
    return np.asarray(v, dtype=np.float64) / float(SCALE)


def trunc_div(a, b) -> np.ndarray:
    """a / b rounded toward zero; b == 0 gives 0."""
    a = np.asarray(a, dtype=np.int64)
    b = np.broadcast_to(np.asarray(b, dtype=np.int64), a.shape)
    safe = np.where(b == 0, 1, b)
    q = np.abs(a) // np.abs(safe)
    q = np.where((a < 0) != (safe < 0), -q, q)
    return np.where(b == 0, 0, q)


def mul(a, b) -> np.ndarray:
    """a * b / 2^12 rounded toward zero."""
    p = np.asarray(a, dtype=np.int64) * np.asarray(b, dtype=np.int64)
    return (p >> SCALE_BITS) + ((p < 0) & ((p & (SCALE - 1)) != 0))


def recip(a) -> np.ndarray:
    a = np.asarray(a, dtype=np.int64)
    return trunc_div(np.full(a.shape, SCALE * SCALE, dtype=np.int64), a)


def exp2(a) -> np.ndarray:
    """exp2 as its lookup table gives it: float64 exp2 of the fixed value,
    encoded again."""
    return from_float(np.exp2(to_float(a)))


def log_size(n_rows: int) -> int:
    return max(MIN_LOG_SIZE, int(math.ceil(math.log2(max(1, n_rows)))))


def lut_range(src: np.ndarray) -> tuple:
    """(lo, hi) raw values of a LUT op's table range from its source."""
    lo, hi = to_float(src.min()), to_float(src.max())
    delta = (hi - lo) * RANGE_MARGIN
    return int(from_float(lo - delta)), int(from_float(hi + delta))


def coalesce(ranges) -> list:
    """Overlapping or adjacent (lo, hi) ranges merged, ascending."""
    out = []
    for lo, hi in sorted(ranges):
        if out and lo <= out[-1][1] + 1:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return [tuple(r) for r in out]


class Tape:
    """Rows a forward pass puts into each trace table.  An op keyed like
    one already taken (the same operation on the same operands) is the
    graph's one node and adds no rows; so does a repeated constant."""

    def __init__(self):
        self.rows = defaultdict(int)
        self._seen = set()
        self.lut_sources = defaultdict(list)
        self.range_check = False

    def op(self, table: str, n: int, key=None) -> None:
        if key is not None:
            if key in self._seen:
                return
            self._seen.add(key)
        self.rows[table] += int(n)

    def const(self, value: float) -> np.ndarray:
        self.op("inputs", 1, ("const", float(value)))
        return from_float(value)
