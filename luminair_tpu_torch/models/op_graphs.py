"""Six small graphs that between them run every op of the trace kernels:
add, mul, rem, less_than (with the range-check table), recip, square,
sqrt (negative inputs too), sin / exp2 / log2 with their lookup tables,
contiguous over slices and broadcasts, sum_reduce and max_reduce along
every axis.  The same graphs, built from the same seeded data, are the
reference package's device-trace cases (tests/test_device_trace.py).

    cx = Graph(); GRAPHS["all_ops"](cx, DATA); cx.compile()
"""

from __future__ import annotations

import numpy as np

_RNG = np.random.default_rng(77)


def _data(shape, lo=0.2, hi=1.2):
    return _RNG.uniform(lo, hi, shape)


def build_all_ops(cx, d):
    a = cx.tensor((3, 4)).set(d["a"])
    b = cx.tensor((3, 4)).set(d["b"])
    (
        (a * b + a).sin()
        + b.sqrt().exp2()
        + a.log2().recip()
        + (a < b)
        + (a % b)
    ).sum_reduce(1).max_reduce(0).retrieve()


def build_mlp(cx, d):
    x = cx.tensor((4, 2)).set(d["x"])
    w1 = cx.tensor((2, 8)).set(d["w1"])
    w2 = cx.tensor((8, 1)).set(d["w2"])
    ((x @ w1).tanh() @ w2).retrieve()


def build_broadcast(cx, d):
    a = cx.tensor((3, 1)).set(d["a31"])
    b = cx.tensor((3, 4)).set(d["b"])
    (a.expand(1, 4) * b + a.expand(1, 4)).sum_reduce(0).retrieve()
    b.square().retrieve()


def build_slices(cx, d):
    a = cx.tensor((4, 4)).set(d["a44"])
    (a.slice_dim(1, 0, 2).contiguous() * 2.0).retrieve()
    t = cx.tensor((4, 1)).set(d["a41"])
    (t.expand(1, 4).contiguous() + 0.5).retrieve()


def build_reduce_axes(cx, d):
    a = cx.tensor((2, 3, 5)).set(d["neg"])
    a.sum_reduce(0).retrieve()
    b = cx.tensor((2, 3, 5)).set(d["neg"])
    b.max_reduce(1).retrieve()
    c = cx.tensor((2, 3, 5)).set(d["neg"])
    c.sum_reduce(2).retrieve()


def build_negative(cx, d):
    a = cx.tensor((4, 4)).set(d["sn"])
    b = cx.tensor((4, 4)).set(d["sn2"])
    ((a * b) + (a < b) + (a % b)).retrieve()
    a.sqrt().retrieve()  # negative inputs clamp to 0 inside sqrt


DATA = {
    "a": _data((3, 4)),
    "b": _data((3, 4)),
    "x": _data((4, 2), -1.0, 1.0),
    "w1": _data((2, 8), -0.7, 0.7),
    "w2": _data((8, 1), -0.7, 0.7),
    "a31": _data((3, 1)),
    "a44": _data((4, 4)),
    "a41": _data((4, 1)),
    "neg": _data((2, 3, 5), -2.0, 2.0),
    "sn": _data((4, 4), -3.0, 3.0),
    "sn2": _data((4, 4), -2.0, 2.0),
}

GRAPHS = {
    "all_ops": build_all_ops,
    "mlp": build_mlp,
    "broadcast": build_broadcast,
    "slices": build_slices,
    "reduce_axes": build_reduce_axes,
    "negative": build_negative,
}
