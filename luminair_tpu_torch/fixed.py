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
"""

from __future__ import annotations

import numpy as np

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
