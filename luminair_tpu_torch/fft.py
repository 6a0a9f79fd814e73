"""Circle FFT / iFFT / LDE over batched M31 columns, and evaluation at a
QM31 circle point.

Butterflies follow the palindromic structure of the natural coset row order
(circle.py): the circle stage pairs rows (i, N-1-i) with twiddle y_i; a line
stage pairs (j, M-1-j) inside each block of size M with the x-chain
twiddles.  Coefficient basis, index bits MSB..LSB = [y, x, pi(x), ...]:
  b_j(x, y) = y^bit_{n-1} * x^bit_{n-2} * pi(x)^bit_{n-3} * ...

The low-degree extension embeds a 2^n coefficient vector into 2^(n+B) by
striding (zeros in the low bits) and evaluates on the larger domain.  The
transforms run in the circle-FFT kernel (kernels.circle_*, K1) for CUDA
tensors and in its plain twin for CPU tensors.

Columns are int32 (..., N) tensors; QM31 values are int64 (4,) tensors.
"""

from __future__ import annotations

import torch

from . import circle
from . import fields as f
from . import kernels


def _batched(fn, a, *args):
    lead = a.shape[:-1]
    out = fn(a.reshape(-1, a.shape[-1]), *args)
    return out.reshape(lead + (out.shape[-1],))


def ifft(values: torch.Tensor) -> torch.Tensor:
    """Interpolate: domain values (..., N) -> coefficients (..., N)."""
    return _batched(kernels.circle_ifft, values)


def fft(coeffs: torch.Tensor, m_start: int = 2) -> torch.Tensor:
    """Evaluate: coefficients (..., N) -> domain values (..., N).  m_start > 2
    skips the deepest line stages (the input already holds their output)."""
    return _batched(kernels.circle_fft, coeffs, m_start)


def extend_coeffs_and_fft(coeffs: torch.Tensor, log_blowup: int) -> torch.Tensor:
    """Coefficients (..., n) -> evaluations (..., n << log_blowup)."""
    return _batched(kernels.circle_lde, coeffs, log_blowup)


def lde(values: torch.Tensor, log_blowup: int) -> torch.Tensor:
    """Low-degree extend values on D_n to D_{n + log_blowup}."""
    return extend_coeffs_and_fft(ifft(values), log_blowup)


def _twiddle_chain(log_n: int, point):
    """[y, x, pi(x), ..., pi^(n-2)(x)] of a QM31 point, MSB first."""
    x, y = point
    ts = [y]
    cur = x
    for _ in range(log_n - 1):
        ts.append(cur)
        cur = circle.pi_x_qm31(cur)
    return ts


def eval_at_point(coeffs: torch.Tensor, point) -> torch.Tensor:
    """Evaluate M31 coefficient vectors (..., N) at a QM31 point by halving
    folds; (..., 4) int64."""
    c = coeffs.to(f.I64)
    log_n = c.shape[-1].bit_length() - 1
    if log_n == 0:
        return f.qm31_from_m31(c[..., 0])
    ts = _twiddle_chain(log_n, (point[0].to(c.device), point[1].to(c.device)))
    a = f.qm31_from_m31(c)  # (..., N, 4)
    for lvl in range(log_n - 1, -1, -1):
        a = f.add(a[..., 0::2, :], f.qm31_mul(a[..., 1::2, :], ts[lvl]))
    return a[..., 0, :]


def basis_at_point(log_n: int, point, device) -> torch.Tensor:
    """All 2^log_n basis functions at a QM31 point, (N, 4) int64, built in
    log_n doubling steps."""
    ts = _twiddle_chain(log_n, (point[0].to(device), point[1].to(device)))
    basis = f.qm31_one((1,), device)
    for i in range(log_n):
        basis = torch.cat([basis, f.qm31_mul(ts[log_n - 1 - i], basis)])
    return basis


# Elements of one modular-product chunk: bounds the (C, N, 4) int64 temp.
_DOT_CHUNK = 1 << 24


def mod_dot(coeffs: torch.Tensor, basis: torch.Tensor) -> torch.Tensor:
    """(C, N) M31 x (N, 4) M31 -> (C, 4) mod P, exact: each product is
    reduced below 2^31, so a sum of up to 2^32 of them fits int64."""
    c64 = coeffs.to(f.I64)
    n = c64.shape[1]
    rows = max(1, _DOT_CHUNK // (4 * n))
    out = []
    for s in range(0, c64.shape[0], rows):
        prod = (c64[s : s + rows, :, None] * basis[None]) % f.P
        out.append(prod.sum(dim=1) % f.P)
    return torch.cat(out)


def eval_at_point_many(coeffs2d: torch.Tensor, point) -> torch.Tensor:
    """Many same-size M31 coefficient vectors (C, N) at one QM31 point:
    one basis vector and one modular product.  (C, 4) int64."""
    n = coeffs2d.shape[1]
    log_n = n.bit_length() - 1
    if log_n == 0:
        return f.qm31_from_m31(coeffs2d[:, 0].to(f.I64))
    return mod_dot(coeffs2d, basis_at_point(log_n, point, coeffs2d.device))


def line_ifft_qm31(values: torch.Tensor, twiddles_inv) -> torch.Tensor:
    """Interpolate a QM31 evaluation (L, 4) on a line domain into line
    coefficients (basis MSB..LSB = [x, pi(x), ...]); twiddles_inv: 1/(2x)
    per stage (lengths L/2, L/4, ...).  int64 in and out."""
    L = values.shape[-2]
    a = values
    n_blocks, m, stage = 1, L, 0
    while m >= 2:
        t = twiddles_inv[stage].to(a.device)[:, None]
        blocks = a.reshape(n_blocks, m, 4)
        v0 = blocks[:, : m // 2]
        v1 = blocks[:, m // 2 :].flip(1)
        e = f.mul(f.add(v0, v1), f.INV2)
        o = f.mul(f.sub(v0, v1), t)
        a = torch.cat([e, o], dim=1).reshape(L, 4)
        n_blocks *= 2
        m //= 2
        stage += 1
    return a
