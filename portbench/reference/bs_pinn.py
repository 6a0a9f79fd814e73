"""Plain reference of the Black-Scholes PINN: Linear layers with tanh
between them, in the graph's fixed-point semantics.

The graph builds tanh(z) as 2 * sigmoid(2 z) - 1 with sigmoid(u) =
1 / (exp2(-u / ln 2) + 1): multiplications by the constants 2, -1 and
1/ln 2, exp2 through its lookup table, an add of 1, a reciprocal, a
product by 2 and an add of the product 1 * -1.  A matmul is a
broadcast product and a sum over the shared axis; the bias is added.
Every operation's rows go on the tape, with the graph's merging of
identical nodes (constants by value; the product 1 * -1 once for each
shape).
"""

from __future__ import annotations

import math

import numpy as np

from . import fixed as fx


def forward(cfg: dict, weights: dict, inputs: dict):
    """(raw int64 outputs (batch, out), tape)."""
    tape = fx.Tape()
    x = np.asarray(inputs["x"], dtype=np.float64)
    tape.op("inputs", x.size)
    h = fx.from_float(x)
    sizes = cfg["layers"]
    for i, (fan_in, fan_out) in enumerate(sizes, start=1):
        w = fx.from_float(weights[f"w{i}"])
        b = fx.from_float(weights[f"b{i}"])
        tape.op("inputs", w.size + b.size)
        prod = fx.mul(h[:, None, :], w.T[None, :, :])  # (batch, out, in)
        tape.op("mul", prod.size)
        tape.op("sum_reduce", prod.size)
        z = prod.sum(axis=2) + b[None, :]
        tape.op("add", z.size)
        h = z if i == len(sizes) else _tanh(tape, z)
    return h, tape


def _tanh(tape: fx.Tape, z: np.ndarray) -> np.ndarray:
    n = z.size
    two, minus_one = tape.const(2.0), tape.const(-1.0)
    inv_ln2, one = tape.const(1.0 / math.log(2.0)), tape.const(1.0)
    u = fx.mul(fx.mul(fx.mul(z, two), minus_one), inv_ln2)
    tape.op("mul", 3 * n)
    tape.lut_sources["exp2"].append(u)
    e = fx.exp2(u)
    tape.op("exp2", n)
    r = fx.recip(e + one)
    tape.op("add", n)
    tape.op("recip", n)
    m = fx.mul(r, two)
    tape.op("mul", n)
    neg_one = fx.mul(np.full(z.shape, one), minus_one)
    tape.op("mul", n, key=("one_times_minus_one", z.shape))
    tape.op("add", n)
    return m + neg_one


def forward_float32(cfg: dict, weights: dict, inputs: dict):
    """The control: the same network in float32 arithmetic; (its outputs
    encoded in fixed point, a tape holding the exp2 tables' sources)."""
    tape = fx.Tape()
    h = np.asarray(inputs["x"], dtype=np.float32)
    sizes = cfg["layers"]
    for i in range(1, len(sizes) + 1):
        h = h @ np.asarray(weights[f"w{i}"], dtype=np.float32) + np.asarray(weights[f"b{i}"], dtype=np.float32)
        if i < len(sizes):
            tape.lut_sources["exp2"].append(fx.from_float((h * np.float32(-2.0 / math.log(2.0))).astype(np.float64)))
            h = np.tanh(h)
    return fx.from_float(h.astype(np.float64)), tape
