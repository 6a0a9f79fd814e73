"""Fixed-point numerics over M31 (host, numpy).

A value is an int64 ``v`` representing ``v / 2^SCALE`` with SCALE = 12.

  add:   out = a + b                                   a + b - out == 0
  mul:   prod = a*b; out = trunc(prod / s); rem = prod - out*s
                                                       a*b == out*s + rem
  recip: out = trunc(s^2 / a); rem = s^2 - a*out       a*out + rem == s^2
  sqrt:  out = isqrt(a * s);   rem = a*s - out^2       out^2 + rem == a*s
  div_rem (Mod op): q = trunc(a/b); rem = a - q*b      q*b + rem == a

trunc rounds toward zero.  The identities hold over the integers, hence
over M31 after embedding ``to_m31(v) = v mod p``, which is what the
constraints check.  (The reference package's fixed.py, host path.)

The ``t_*`` functions are the same arithmetic on int64 torch tensors, bit
for bit: products and sums wrap modulo 2^64 as numpy's do, ``t_to_m31`` is
a floor-mod, a division by 0 gives 0, and the one division that overflows
(INT64_MIN / -1) gives the wrapped negation, as numpy's floor-division path
does.  They are the plain versions of the trace kernels (csrc/trace.cu).
"""

from __future__ import annotations

import numpy as np
import torch

DEFAULT_FP_SCALE = 12
SCALE_FACTOR = np.int64(1 << DEFAULT_FP_SCALE)
_P = np.int64((1 << 31) - 1)

_SAFE_MAX = float(1 << 62)


def from_float(x) -> np.ndarray:
    """Round-to-nearest fixed encoding; values beyond +-2^62 saturate."""
    scaled = np.round(np.asarray(x, dtype=np.float64) * float(SCALE_FACTOR))
    scaled = np.nan_to_num(scaled, nan=0.0, posinf=_SAFE_MAX, neginf=-_SAFE_MAX)
    return np.clip(scaled, -_SAFE_MAX, _SAFE_MAX).astype(np.int64)


def to_float(v) -> np.ndarray:
    return np.asarray(v, dtype=np.float64) / float(SCALE_FACTOR)


def to_m31(v) -> np.ndarray:
    """v mod p as uint32 (floor-mod: non-negative for negative v)."""
    return (np.asarray(v, dtype=np.int64) % _P).astype(np.uint32)


def add(a, b):
    return np.asarray(a, dtype=np.int64) + np.asarray(b, dtype=np.int64)


def _trunc_div(a, b):
    """Truncated (toward-zero) division, matching Rust i64 `/`."""
    a = np.asarray(a, dtype=np.int64)
    b = np.asarray(b, dtype=np.int64)
    safe = np.where(b == 0, np.ones_like(b), b)
    q = np.where(b != 0, a // safe, np.zeros_like(a))
    r = a - q * b
    adjust = (r != 0) & ((a < 0) != (b < 0)) & (b != 0)
    return q + adjust


def mul(a, b):
    """(out, rem) with a*b == out*2^S + rem."""
    prod = np.asarray(a, dtype=np.int64) * np.asarray(b, dtype=np.int64)
    out = _trunc_div(prod, SCALE_FACTOR)
    return out, prod - out * SCALE_FACTOR


def square(a):
    """(out, rem) with a*a == out*2^S + rem."""
    prod = np.asarray(a, dtype=np.int64) ** 2
    out = _trunc_div(prod, SCALE_FACTOR)
    return out, prod - out * SCALE_FACTOR


def recip(a):
    """(out, rem) with a*out + rem == 2^(2S); a == 0 -> (0, s^2)."""
    a = np.asarray(a, dtype=np.int64)
    s2 = SCALE_FACTOR * SCALE_FACTOR
    out = _trunc_div(np.full(a.shape, s2, dtype=np.int64), a)
    return out, s2 - a * out


def sqrt(a):
    """(out, rem) with out^2 + rem == a*2^S, out = isqrt(a*2^S)."""
    a = np.asarray(a, dtype=np.int64)
    prod = a * SCALE_FACTOR
    clipped = np.maximum(prod, np.zeros_like(prod))
    # The float sqrt is an estimate within +-1 of isqrt; clamp it exact.
    out = np.sqrt(clipped.astype(np.float64)).astype(np.int64)
    out = np.where((out + 1) * (out + 1) <= clipped, out + 1, out)
    out = np.where(out * out > clipped, out - 1, out)
    return out, prod - out * out


def div_rem(a, b):
    """Fixed `Mod`: q = trunc(a/b), rem = a - q*b; b == 0 -> (0, a)."""
    a = np.asarray(a, dtype=np.int64)
    b = np.asarray(b, dtype=np.int64)
    q = _trunc_div(a, b)
    return q, a - q * b


def less_than(a, b):
    """Borrow-style comparison on raw fixed values: (out_fixed, borrow,
    diff) -- a < b: (1.0, 0, b - a); else (0, 1, b - a + 2^31 - 1)."""
    a = np.asarray(a, dtype=np.int64)
    b = np.asarray(b, dtype=np.int64)
    lt = a < b
    out = np.where(lt, SCALE_FACTOR, 0).astype(np.int64)
    borrow = np.where(lt, 0, 1).astype(np.int64)
    diff = b - a + np.where(lt, np.int64(0), np.int64((1 << 31) - 1))
    return out, borrow, diff


# ---------------------------------------------------------------------------
# The same arithmetic on int64 tensors (any device).

_T_SCALE = 1 << DEFAULT_FP_SCALE
_T_P = (1 << 31) - 1


def t_from_float(x: torch.Tensor) -> torch.Tensor:
    """`from_float` on a float64 tensor: x * 2^S rounded half to even, NaN
    to 0, saturated at +-2^62 (the plain version of the trace kernel's
    encode item)."""
    scaled = torch.round(x.to(torch.float64) * _T_SCALE)
    scaled = torch.nan_to_num(scaled, nan=0.0, posinf=_SAFE_MAX, neginf=-_SAFE_MAX)
    return torch.clamp(scaled, -_SAFE_MAX, _SAFE_MAX).to(torch.int64)


def t_to_m31(v: torch.Tensor) -> torch.Tensor:
    """v mod p (floor-mod), as int64 values in [0, p)."""
    return torch.remainder(v, _T_P)


def t_add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a + b


def t_trunc_div(a: torch.Tensor, b) -> torch.Tensor:
    """Truncated division; b == 0 gives 0, a / -1 the wrapped negation."""
    b = torch.as_tensor(b, dtype=torch.int64, device=a.device).expand_as(a)
    safe = torch.where((b == 0) | (b == -1), torch.ones_like(b), b)
    q = torch.div(a, safe, rounding_mode="trunc")
    q = torch.where(b == -1, -a, q)
    return torch.where(b == 0, torch.zeros_like(q), q)


def t_mul(a: torch.Tensor, b: torch.Tensor):
    prod = a * b
    out = t_trunc_div(prod, _T_SCALE)
    return out, prod - out * _T_SCALE


def t_square(a: torch.Tensor):
    return t_mul(a, a)


def t_recip(a: torch.Tensor):
    s2 = torch.full_like(a, _T_SCALE * _T_SCALE)
    out = t_trunc_div(s2, a)
    return out, s2 - a * out


def t_sqrt(a: torch.Tensor):
    """isqrt(a * 2^S) from the float64 estimate and one clamp each way, as
    the host computes it (a correctly rounded sqrt on every device gives the
    same estimate)."""
    prod = a * _T_SCALE
    clipped = torch.clamp(prod, min=0)
    out = torch.sqrt(clipped.to(torch.float64)).to(torch.int64)
    out = torch.where((out + 1) * (out + 1) <= clipped, out + 1, out)
    out = torch.where(out * out > clipped, out - 1, out)
    return out, prod - out * out


def t_div_rem(a: torch.Tensor, b: torch.Tensor):
    q = t_trunc_div(a, b)
    return q, a - q * b


def t_less_than(a: torch.Tensor, b: torch.Tensor):
    """(out_fixed, borrow, diff) as in `less_than`."""
    lt = a < b
    out = torch.where(lt, _T_SCALE, 0).to(torch.int64)
    borrow = (~lt).to(torch.int64)
    diff = b - a + torch.where(lt, 0, _T_P).to(torch.int64)
    return out, borrow, diff
