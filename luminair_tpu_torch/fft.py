"""Circle FFT / iFFT / LDE over batched M31 columns, and evaluation at a
QM31 circle point.

Butterflies follow the palindromic structure of the natural coset row order
(circle.py): the circle stage pairs rows (i, N-1-i) with twiddle y_i; a line
stage pairs (j, M-1-j) inside each block of size M with the x-chain
twiddles.  Coefficient basis, index bits MSB..LSB = [y, x, pi(x), ...]:
  b_j(x, y) = y^bit_{n-1} * x^bit_{n-2} * pi(x)^bit_{n-3} * ...

The low-degree extension embeds a 2^n coefficient vector into 2^(n+B) by
striding (zeros in the low bits) and evaluates on the larger domain.  The
transforms run in the circle-FFT kernel (kernels.circle_*, K1) and the
evaluation of groups of columns, each at its point, in the OODS kernel
(kernels.oods_eval_many, K7) for CUDA tensors, in their plain twins for
CPU tensors.

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


def twiddle_chain(log_n: int, point) -> list:
    """[y, x, pi(x), ..., pi^(n-2)(x)] of a QM31 point, MSB first, as
    4-tuples of ints (host words)."""
    x, y = f.qm31_words(point[0]), f.qm31_words(point[1])
    ts, one = [y], (1, 0, 0, 0)
    for _ in range(log_n - 1):
        ts.append(x)
        x2 = f.qm31_mul_ints(x, x)
        x = tuple((2 * a - b) % f.P for a, b in zip(x2, one))
    return ts[:log_n]


def eval_at_point_many(groups) -> torch.Tensor:
    """Groups (coeffs, point) of same-size M31 coefficient columns ((C, N)
    tensor or C columns of length N), each at its QM31 point, in one call
    of the OODS kernel (K7); (sum C, 4) int32, groups in order."""
    out = []
    for coeffs, point in groups:
        cols = list(coeffs)
        out.append((cols, twiddle_chain(cols[0].shape[0].bit_length() - 1, point)))
    return kernels.oods_eval_many(out)


def line_ifft_qm31(values: torch.Tensor, twiddles_inv) -> torch.Tensor:
    """Interpolate a QM31 evaluation (L, 4) on a line domain into line
    coefficients (basis MSB..LSB = [x, pi(x), ...]); twiddles_inv: 1/(2x)
    per stage (lengths L/2, L/4, ...).  int64 in and out."""
    L = values.shape[-2]
    a = values
    n_blocks, m, stage = 1, L, 0
    while m >= 2:
        t = f.to_device(twiddles_inv[stage], a.device)[:, None]
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


def line_eval_at_x(coeffs: torch.Tensor, x) -> torch.Tensor:
    """Evaluate line coefficients (L, 4) (the basis of `line_ifft_qm31`:
    MSB..LSB = [x, pi(x), ...]) at M31 x-coordinates `x` (a scalar or a
    tensor of them): (..., 4) int64 on the host."""
    x = f.host_i64(x)
    L = coeffs.shape[-2]
    ts = []
    for _ in range(L.bit_length() - 1):
        ts.append(circle.pi_x(ts[-1]) if ts else x)
    a = f.host_i64(coeffs).expand(x.shape + (L, 4))
    for t in reversed(ts):
        a = a.reshape(x.shape + (a.shape[-2] // 2, 2, 4))
        a = f.add(a[..., 0, :], f.mul(a[..., 1, :], t[..., None, None]))
    return a[..., 0, :]
