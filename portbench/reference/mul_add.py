"""Plain reference of the N x N graph a * b + a in the graph's
fixed-point semantics: the product rounds toward zero."""

from __future__ import annotations

import numpy as np

from . import fixed as fx


def forward(cfg: dict, weights: dict, inputs: dict):
    """(raw int64 outputs (n, n), tape)."""
    tape = fx.Tape()
    a, b = fx.from_float(inputs["a"]), fx.from_float(inputs["b"])
    tape.op("inputs", a.size + b.size)
    out = fx.mul(a, b) + a
    tape.op("mul", a.size)
    tape.op("add", a.size)
    return out, tape


def forward_float32(cfg: dict, weights: dict, inputs: dict):
    """The control: a * b + a in float32, encoded in fixed point (and an
    empty tape: the graph has no lookup table)."""
    a, b = np.asarray(inputs["a"], dtype=np.float32), np.asarray(inputs["b"], dtype=np.float32)
    return fx.from_float((a * b + a).astype(np.float64)), fx.Tape()
