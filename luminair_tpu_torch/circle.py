"""Circle group over M31, canonic domains and FFT twiddles.

The circle C(M31) = {(x, y): x^2 + y^2 = 1} is cyclic of order 2^31 with
generator G = (2, 1268011823).  The canonic domain of size N = 2^n is the
coset D_n = {(2i+1) * G_{n+1} : i in [0, N)} in natural row order: row i is
the point (2i+1) * G_{n+1}, the previous row is a cyclic roll, and
conjugation pairs row i with row N-1-i (the FFT's palindromic butterflies).

Tables are generated once per log size on the host (int64 CPU tensors) and
uploaded once per (log size, device) as int32 words.  A twiddle table is one
flat tensor: stage s of a size-2^n transform holds 2^(n-1-s) words starting
at offset 2^n - 2^(n-s) (`stage_offset`).
"""

from __future__ import annotations

from functools import lru_cache

import torch

from . import fields as f

M31_CIRCLE_GEN = (2, 1268011823)
M31_CIRCLE_LOG_ORDER = 31

# ---------------------------------------------------------------------------
# Scalar base-field points (python ints).


def _int_point_add(p, q):
    x1, y1 = p
    x2, y2 = q
    return ((x1 * x2 - y1 * y2) % f.P, (x1 * y2 + y1 * x2) % f.P)


def _int_point_double(p):
    return _int_point_add(p, p)


@lru_cache(maxsize=64)
def group_gen(log_size: int):
    """Generator of the order-2^log_size subgroup, as python ints."""
    g = M31_CIRCLE_GEN
    for _ in range(M31_CIRCLE_LOG_ORDER - log_size):
        g = _int_point_double(g)
    return g


# ---------------------------------------------------------------------------
# Vectorised base-field points and the squaring map.


def point_add(p, q):
    x1, y1 = p
    x2, y2 = q
    return (
        f.sub(f.mul(x1, x2), f.mul(y1, y2)),
        f.add(f.mul(x1, y2), f.mul(y1, x2)),
    )


def pi_x(x):
    """The squaring map on x-coordinates: pi(x) = 2x^2 - 1."""
    x2 = f.mul(x, x)
    return f.sub(f.add(x2, x2), 1)


def coset_vanishing_eval(x, trace_log_size: int):
    """V_n(P) = pi^(n-1)(x(P)), the vanishing polynomial of D_n."""
    v = x
    for _ in range(trace_log_size - 1):
        v = pi_x(v)
    return v


# ---------------------------------------------------------------------------
# QM31 points: (x, y) pairs of (4,) int64 tensors.


def point_add_qm31(p, q):
    x1, y1 = p
    x2, y2 = q
    return (
        f.sub(f.qm31_mul(x1, x2), f.qm31_mul(y1, y2)),
        f.add(f.qm31_mul(x1, y2), f.qm31_mul(y1, x2)),
    )


def point_neg_qm31(p):
    return (p[0], f.neg(p[1]))


def point_sub_qm31(p, q):
    return point_add_qm31(p, point_neg_qm31(q))


def point_to_qm31(p, device="cpu"):
    return (f.qm31_from_ints(p[0], device=device), f.qm31_from_ints(p[1], device=device))


def point_from_t_qm31(t):
    """The circle point x = (1-t^2)/(1+t^2), y = 2t/(1+t^2) (OODS point)."""
    one = f.qm31_from_ints(1, device=t.device)
    t2 = f.qm31_mul(t, t)
    denom_inv = f.qm31_inv(f.add(one, t2))
    return (f.qm31_mul(f.sub(one, t2), denom_inv), f.qm31_mul(f.add(t, t), denom_inv))


def pi_x_qm31(x):
    x2 = f.qm31_mul(x, x)
    return f.sub(f.add(x2, x2), f.qm31_from_ints(1, device=x.device))


def coset_vanishing_eval_qm31(x, trace_log_size: int):
    v = x
    for _ in range(trace_log_size - 1):
        v = pi_x_qm31(v)
    return v


# ---------------------------------------------------------------------------
# Domains and twiddles (host int64).


@lru_cache(maxsize=32)
def domain_points(log_size: int):
    """(xs, ys) int64 CPU tensors with (xs[i], ys[i]) = (2i+1) * G_{n+1},
    built by offset doubling: the next k points are the first k plus 2k*q."""
    n = 1 << log_size
    q = group_gen(log_size + 1)
    xs = torch.tensor([q[0]], dtype=f.I64)
    ys = torch.tensor([q[1]], dtype=f.I64)
    offset = _int_point_double(q)
    k = 1
    while k < n:
        nx, ny = point_add((xs, ys), offset)
        xs = torch.cat([xs, nx])
        ys = torch.cat([ys, ny])
        offset = _int_point_double(offset)
        k *= 2
    return xs, ys


@lru_cache(maxsize=32)
def fft_twiddles(log_size: int):
    """Forward twiddles per stage: [0] = y of the first N/2 points (circle
    stage); [k] = the x chain after k-1 squarings, first N/2^(k+1) entries."""
    n = 1 << log_size
    xs, ys = domain_points(log_size)
    tw = [ys[: n // 2].clone()]
    cur = xs[: n // 2].clone()
    while len(cur) >= 2:
        tw.append(cur[: len(cur) // 2].clone())
        cur = pi_x(cur[: len(cur) // 2])
    return tw


@lru_cache(maxsize=32)
def ifft_twiddles(log_size: int):
    """Inverse twiddles 1/(2t) per stage."""
    return [f.mul(f.inv(t), f.INV2) for t in fft_twiddles(log_size)]


def stage_offset(log_size: int, stage: int) -> int:
    return (1 << log_size) - (1 << (log_size - stage))


@lru_cache(maxsize=64)
def twiddle_table(log_size: int, inverse: bool, device: torch.device) -> torch.Tensor:
    """All stages of a size-2^log_size transform, flat int32 on `device`."""
    tw = ifft_twiddles(log_size) if inverse else fft_twiddles(log_size)
    if not tw:
        return torch.zeros(0, dtype=f.I32, device=device)
    return torch.cat(tw).to(f.I32).to(device)


def twiddle_stage(log_size: int, stage: int, inverse: bool, device) -> torch.Tensor:
    """One stage's row of `twiddle_table`: 2^(log_size-1-stage) int32 words."""
    table = twiddle_table(log_size, inverse, device)
    off = stage_offset(log_size, stage)
    return table[off : off + (1 << (log_size - 1 - stage))]


@lru_cache(maxsize=64)
def domain_table(log_size: int, device: torch.device):
    """(xs, ys) of D_log_size as int32 on `device`."""
    xs, ys = domain_points(log_size)
    return xs.to(f.I32).to(device), ys.to(f.I32).to(device)
