"""LuminairPie: the artifact between trace generation and proving.

Trace tables are column-oriented uint32 (M31) numpy arrays on the host,
padded to a power of two at proving time and uploaded by the prover.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np

from .preprocessed import calculate_log_size

#: padding value per column name (default 0): padding rows must satisfy all
#: constraints (zeros with is_last_idx = 1).
_PADDING_ONES = {"is_last_idx"}

#: per-table overrides: less_than pads with a valid comparison row
#: (0 < 1 -> out = 1.0 fixed, diff = 1, limb0 = 1); the reductions pad
#: is_last_step = 1 so their cross-row masks are released on padding rows.
_PADDING_OVERRIDES = {
    "less_than": {"rhs": 1, "out": 1 << 12, "diff": 1, "limb0": 1},
    "sum_reduce": {"is_last_step": 1},
    "max_reduce": {"is_last_step": 1},
}


@dataclass
class TraceTable:
    name: str
    columns: Dict[str, np.ndarray]

    @property
    def n_rows(self) -> int:
        if not self.columns:
            return 0
        return len(next(iter(self.columns.values())))

    @property
    def log_size(self) -> int:
        return calculate_log_size(self.n_rows)

    def padded_columns(self, col_order: List[str]) -> Dict[str, np.ndarray]:
        n = self.n_rows
        size = 1 << self.log_size
        overrides = _PADDING_OVERRIDES.get(self.name, {})
        out = {}
        for name in col_order:
            pad_val = overrides.get(name, 1 if name in _PADDING_ONES else 0)
            padded = np.full(size, pad_val, dtype=np.uint32)
            padded[:n] = np.asarray(self.columns[name], dtype=np.uint32)
            out[name] = padded
        return out


@dataclass
class ExecutionResources:
    op_counter: Dict[str, int] = field(default_factory=dict)
    max_log_size: int = 0


@dataclass
class Metadata:
    execution_resources: ExecutionResources


@dataclass
class LuminairPie:
    trace_tables: Dict[str, TraceTable]
    metadata: Metadata


def pie_from_arrays(
    tables: Dict[str, Tuple[int, Dict[str, np.ndarray]]],
    op_counter: Dict[str, int] = None,
) -> LuminairPie:
    """A PIE from plain arrays: {component: (log_size, {column: uint32
    array})}, e.g. taken from another implementation's PIE."""
    trace_tables = {}
    for name, (log_size, cols) in tables.items():
        t = TraceTable(name, {k: np.asarray(v, dtype=np.uint32) for k, v in cols.items()})
        if t.n_rows and t.log_size != log_size:
            raise ValueError(f"{name}: {t.n_rows} rows do not pad to log size {log_size}")
        trace_tables[name] = t
    max_log = max((t.log_size for t in trace_tables.values()), default=0)
    return LuminairPie(trace_tables, Metadata(ExecutionResources(dict(op_counter or {}), max_log)))
