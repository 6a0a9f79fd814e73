"""M31 and QM31 field arithmetic on torch tensors.

Values are canonical residues in [0, P) held in int64 tensors while they are
computed on: a product of two residues is below 2^62, so a plain int64
multiply followed by `% P` is exact, and a sum of two products is below 2^63.
Stored columns are int32 tensors holding the same words (canonical M31 values
are below 2^31); `u32_to_tensor` / `tensor_to_u32` convert from and to the
uint32 numpy words the transcript and the wire format use.

Every copy between the host and a card goes through the helpers here
(`u32_to_tensor`, `tensor_to_u32`, `host_i64`, `upload`, `to_device`,
`to_host`, `copy`), which count its bytes in tracing's store by kind:
host-to-device from pageable or from pinned memory, device-to-host.

QM31 = CM31[u]/(u^2 - (2+i)), CM31 = M31[i]/(i^2+1).  An element
(a + b*i) + (c + d*i)*u is the last-axis vector [a, b, c, d], as in the
reference package's fields/qm31.py.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from . import tracing

P = (1 << 31) - 1
INV2 = (P + 1) // 2  # 1/2 in M31

I64 = torch.int64
I32 = torch.int32


# ---------------------------------------------------------------------------
# Conversions between uint32 numpy words and torch tensors.


def _count(src: torch.Tensor, device) -> None:
    """Counts a copy of `src` to `device` if it crosses between host and
    card."""
    to_card = torch.device(device).type == "cuda"
    if to_card == src.is_cuda:
        return
    kind = tracing.D2H if src.is_cuda else tracing.H2D_PINNED if src.is_pinned() else tracing.H2D_PAGEABLE
    tracing.count(kind, src.numel() * src.element_size())


def to_device(t: torch.Tensor, device, non_blocking: bool = False) -> torch.Tensor:
    """`t.to(device)`, counted."""
    _count(t, device)
    return t.to(device, non_blocking=non_blocking)


def to_host(t: torch.Tensor) -> torch.Tensor:
    """`t.cpu()`, counted."""
    _count(t, "cpu")
    return t.cpu()


def copy(dst: torch.Tensor, src: torch.Tensor, non_blocking: bool = False) -> torch.Tensor:
    """`dst.copy_(src)`, counted."""
    _count(src, dst.device)
    return dst.copy_(src, non_blocking=non_blocking)


def u32_to_tensor(a, device="cpu", dtype=I32) -> torch.Tensor:
    """uint32 numpy words -> int32 tensor (bit-cast) or int64 (value)."""
    arr = np.ascontiguousarray(np.asarray(a, dtype=np.uint32))
    if dtype == I64:
        return to_device(torch.from_numpy(arr.astype(np.int64)), device)
    return to_device(torch.from_numpy(arr.view(np.int32)), device)


def tensor_to_u32(t: torch.Tensor) -> np.ndarray:
    """int32 (bit-cast words) or int64 (values < 2^32) tensor -> uint32."""
    t = to_host(t.detach())
    if t.dtype == I64:
        return t.numpy().astype(np.uint32)
    return np.ascontiguousarray(t.to(I32).numpy()).view(np.uint32)


def host_i64(a) -> torch.Tensor:
    """Words (a uint32 numpy array or sequence) or an int64 tensor as an
    int64 CPU tensor of their values."""
    if isinstance(a, torch.Tensor):
        return to_host(a.detach()).to(I64)
    return torch.from_numpy(np.asarray(a, dtype=np.uint32).astype(np.int64))


def device_key(device) -> torch.device:
    """A device as caches key it: `cuda` becomes the current `cuda:i`, so
    one card never takes two entries, nor an entry of another card."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def upload(a: np.ndarray, device) -> torch.Tensor:
    """One host-to-device copy of a numpy array: pinned and asynchronous on
    the card (stream-ordered before the kernels launched after it)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if torch.device(device).type == "cuda":
        return to_device(t.pin_memory(), device, non_blocking=True)
    return t


def to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 words in [0, 2^32) -> int32 bit patterns."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(I32)


def to_u32_i64(x: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> int64 words in [0, 2^32)."""
    return x.to(I64) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# M31.


def add(a, b):
    return (a + b) % P


def sub(a, b):
    return (a - b) % P  # torch's % takes the sign of the divisor


def neg(a):
    return (-a) % P


def mul(a, b):
    return (a * b) % P


def square(a):
    return mul(a, a)


def pow_const(a, e: int):
    result = torch.ones_like(a)
    base = a
    while e > 0:
        if e & 1:
            result = mul(result, base)
        base = mul(base, base)
        e >>= 1
    return result


def inv(a):
    """a^(P-2) by the 2^k-1 addition chain of the reference (inv(0) = 0)."""

    def pow2k(x, k):
        for _ in range(k):
            x = mul(x, x)
        return x

    t0 = mul(square(a), a)  # a^(2^2-1)
    t1 = mul(pow2k(t0, 2), t0)  # a^(2^4-1)
    t2 = mul(pow2k(t1, 4), t1)  # a^(2^8-1)
    t3 = mul(pow2k(t2, 8), t2)  # a^(2^16-1)
    t4 = mul(pow2k(t3, 8), t2)  # a^(2^24-1)
    t5 = mul(pow2k(t4, 4), t1)  # a^(2^28-1)
    t6 = mul(pow2k(t5, 1), a)  # a^(2^29-1)
    return mul(pow2k(t6, 2), a)  # a^(2^31-3)


# ---------------------------------------------------------------------------
# QM31 on (..., 4) int64 tensors.


@lru_cache(maxsize=256)
def _constant(values: tuple, device: torch.device) -> torch.Tensor:
    return to_device(torch.tensor(values, dtype=I64), device)


def constant(values, device="cpu") -> torch.Tensor:
    """A small read-only int64 tensor, made once per device: a copy from
    pageable host memory waits for the device stream, so constants in hot
    loops must not be re-uploaded.  Cached per `cuda:i`."""
    return _constant(tuple(int(v) for v in values), device_key(device))


def qm31_from_ints(a: int, b: int = 0, c: int = 0, d: int = 0, device="cpu"):
    """A read-only QM31 constant (see `constant`)."""
    return constant((a % P, b % P, c % P, d % P), device)


def qm31_from_m31(a):
    z = torch.zeros_like(a)
    return torch.stack([a, z, z, z], dim=-1)


def qm31_zero(shape=(), device="cpu"):
    return torch.zeros(tuple(shape) + (4,), dtype=I64, device=device)


def qm31_one(shape=(), device="cpu"):
    o = qm31_zero(shape, device)
    o[..., 0] = 1
    return o


# QM31 product as a signed combination of the 16 coordinate products
# p[i][j] = x_i * y_j:  (A + Bu)(C + Du) = AC + (2+i)BD + (AD + BC)u.
_QM31_MUL = [
    {(0, 0): 1, (1, 1): -1, (2, 2): 2, (3, 3): -2, (2, 3): -1, (3, 2): -1},
    {(0, 1): 1, (1, 0): 1, (2, 2): 1, (3, 3): -1, (2, 3): 2, (3, 2): 2},
    {(0, 2): 1, (1, 3): -1, (2, 0): 1, (3, 1): -1},
    {(0, 3): 1, (1, 2): 1, (2, 1): 1, (3, 0): 1},
]
_QM31_MUL_MATRIX = [[row.get((i, j), 0) for i in range(4) for j in range(4)] for row in _QM31_MUL]


def qm31_mul(x, y):
    """A handful of launches for any batch: the 16 products, each reduced
    below 2^31, then one signed combination (|sum| < 8P) and a reduction."""
    x, y = torch.broadcast_tensors(x, y)
    prod = (x.unsqueeze(-1) * y.unsqueeze(-2)) % P  # (..., 4, 4)
    m = constant(sum(_QM31_MUL_MATRIX, []), prod.device).view(4, 16)
    return (prod.flatten(-2).unsqueeze(-2) * m).sum(-1) % P


def qm31_mul_m31(x, s):
    """QM31 (..., 4) times M31 s, broadcast over the last axis."""
    if isinstance(s, torch.Tensor) and s.dim() > 0:
        s = s.unsqueeze(-1)
    return (x * s) % P


def qm31_inv(x):
    """(A + Bu)^-1 = (A - Bu) / (A^2 - (2+i) B^2); inv(0) = 0."""
    a, b, c, d = x.unbind(-1)
    a2_r, a2_i = (a * a - b * b) % P, (2 * a * b) % P
    b2_r, b2_i = (c * c - d * d) % P, (2 * c * d) % P
    den_r = (a2_r - (2 * b2_r - b2_i)) % P
    den_i = (a2_i - (b2_r + 2 * b2_i)) % P
    ninv = inv((den_r * den_r + den_i * den_i) % P)
    di_r, di_i = (den_r * ninv) % P, (-den_i * ninv) % P
    return torch.stack(
        [
            (a * di_r - b * di_i) % P,
            (a * di_i + b * di_r) % P,
            (-c * di_r + d * di_i) % P,
            (-c * di_i - d * di_r) % P,
        ],
        dim=-1,
    )


def qm31_conj(x):
    """The Gal(QM31/CM31) involution (A + Bu) -> (A - Bu)."""
    return torch.stack([x[..., 0], x[..., 1], neg(x[..., 2]), neg(x[..., 3])], dim=-1)


# ---------------------------------------------------------------------------
# QM31 scalars as 4-tuples of python ints: the host side of a kernel launch
# (power tables, twiddle chains) without a torch launch per operation.


def qm31_words(x) -> tuple:
    """A QM31 value from a (4,) tensor, array or sequence -> 4 ints."""
    vals = x.tolist() if hasattr(x, "tolist") else list(x)
    if len(vals) != 4:
        raise ValueError("expected one QM31 value (4 words)")
    return tuple(int(v) for v in vals)


def qm31_mul_ints(x: tuple, y: tuple) -> tuple:
    a, b, c, d = x
    e, g, h, k = y
    ac_r, ac_i = a * e - b * g, a * g + b * e
    bd_r, bd_i = c * h - d * k, c * k + d * h
    ad_r, ad_i = a * h - b * k, a * k + b * h
    bc_r, bc_i = c * e - d * g, c * g + d * e
    return (
        (ac_r + 2 * bd_r - bd_i) % P,
        (ac_i + bd_r + 2 * bd_i) % P,
        (ad_r + bc_r) % P,
        (ad_i + bc_i) % P,
    )


def qm31_powers_ints(start: tuple, base: tuple, count: int):
    """([start * base^i for i < count], start * base^count)."""
    out, cur = [], tuple(start)
    for _ in range(count):
        out.append(cur)
        cur = qm31_mul_ints(cur, base)
    return out, cur
