"""LuminairPie: the artifact between trace generation and proving.

A trace table is column-oriented M31 words in one of two forms:
  * uint32 numpy arrays on the host (the host interpreter), padded to a
    power of two at proving time and uploaded by the prover;
  * int32 tensors born on a device at their padded size (the device
    interpreter, graph/device_trace.py): `padded` holds each column's whole
    storage, padding rows filled when the table was allocated, and
    `columns` views of its first n_rows.  The prover reads `padded` where
    it lies.
The dict form (`to_dict`, and the PIE file of serde.py) is always the host
form: uint32 numpy columns, n_rows long, padding left out.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..fields import tensor_to_u32
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


def padding_value(table: str, column: str) -> int:
    return _PADDING_OVERRIDES.get(table, {}).get(column, 1 if column in _PADDING_ONES else 0)


@dataclass
class TraceTable:
    name: str
    columns: Dict[str, np.ndarray]
    padded: Optional[Dict[str, torch.Tensor]] = None

    @property
    def n_rows(self) -> int:
        if not self.columns:
            return 0
        return len(next(iter(self.columns.values())))

    @property
    def log_size(self) -> int:
        return calculate_log_size(self.n_rows)

    def padded_columns(self, col_order: List[str]) -> Dict[str, np.ndarray]:
        if self.padded is not None:
            return {name: self.padded[name] for name in col_order}
        n = self.n_rows
        size = 1 << self.log_size
        out = {}
        for name in col_order:
            padded = np.full(size, padding_value(self.name, name), dtype=np.uint32)
            padded[:n] = np.asarray(self.columns[name], dtype=np.uint32)
            out[name] = padded
        return out

    def host_columns(self) -> Dict[str, np.ndarray]:
        """The columns as uint32 numpy words, n_rows long (int32 tensors
        bit-cast, downloaded when they lie on a device)."""
        return {k: tensor_to_u32(v) if isinstance(v, torch.Tensor) else np.asarray(v, dtype=np.uint32)
                for k, v in self.columns.items()}

    def to_dict(self):
        return {"name": self.name, "columns": {k: v.tolist() for k, v in self.host_columns().items()}}

    @staticmethod
    def from_dict(d):
        return TraceTable(d["name"], {k: np.asarray(v, dtype=np.uint32) for k, v in d["columns"].items()})


@dataclass
class ExecutionResources:
    op_counter: Dict[str, int] = field(default_factory=dict)
    max_log_size: int = 0

    def to_dict(self):
        return {"op_counter": dict(self.op_counter), "max_log_size": self.max_log_size}

    @staticmethod
    def from_dict(d):
        return ExecutionResources(dict(d["op_counter"]), int(d["max_log_size"]))


@dataclass
class Metadata:
    execution_resources: ExecutionResources

    def to_dict(self):
        return {"execution_resources": self.execution_resources.to_dict()}

    @staticmethod
    def from_dict(d):
        return Metadata(ExecutionResources.from_dict(d["execution_resources"]))


@dataclass
class LuminairPie:
    trace_tables: Dict[str, TraceTable]
    metadata: Metadata

    def to_dict(self):
        return {
            "trace_tables": {k: t.to_dict() for k, t in self.trace_tables.items()},
            "metadata": self.metadata.to_dict(),
        }

    @staticmethod
    def from_dict(d):
        return LuminairPie(
            {k: TraceTable.from_dict(t) for k, t in d["trace_tables"].items()},
            Metadata.from_dict(d["metadata"]),
        )


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
