"""luminair_tpu_torch.fields against luminair_tpu.fields, element for element."""

import numpy as np
import pytest
import torch

from luminair_tpu.fields import m31 as ref_m31
from luminair_tpu.fields import qm31 as ref_qm31
from luminair_tpu_torch import fields as f

P = (1 << 31) - 1


def _m31_samples(seed, n=257):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, P, size=n, dtype=np.int64).astype(np.uint32)
    a[:4] = [0, 1, P - 1, P - 2]
    return a


def _qm31_samples(seed, n=65):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, P, size=(n, 4), dtype=np.int64).astype(np.uint32)
    a[0] = 0
    a[1] = [P - 1, P - 1, P - 1, P - 1]
    a[2] = [1, 0, 0, 0]
    a[3] = [0, 0, P - 1, 0]
    return a


def _t(a):
    return f.u32_to_tensor(a, dtype=f.I64)


def _eq(port, ref):
    assert np.array_equal(f.tensor_to_u32(port), np.asarray(ref, dtype=np.uint32))


@pytest.mark.parametrize("op", ["add", "sub", "mul"])
def test_m31_binary(op):
    a, b = _m31_samples(1), _m31_samples(2)
    b[:4] = [P - 1, 0, P - 1, 1]
    _eq(getattr(f, op)(_t(a), _t(b)), getattr(ref_m31, op)(a, b))


@pytest.mark.parametrize("op", ["neg", "square", "inv"])
def test_m31_unary(op):
    a = _m31_samples(3)
    ref = ref_m31._inv_chain(a) if op == "inv" else getattr(ref_m31, op)(a)
    _eq(getattr(f, op)(_t(a)), ref)


@pytest.mark.parametrize("e", [0, 1, 2, 5, 17, (1 << 31) - 3])
def test_m31_pow_const(e):
    a = _m31_samples(4)
    _eq(f.pow_const(_t(a), e), ref_m31.pow_const(a, e))


def test_qm31_mul():
    x, y = _qm31_samples(5), _qm31_samples(6)
    _eq(f.qm31_mul(_t(x), _t(y)), ref_qm31.mul(x, y))
    # scalar path of the reference (python ints) against the batched port
    _eq(f.qm31_mul(_t(x[7]), _t(y[9])), ref_qm31.mul(x[7], y[9]))


def test_qm31_mul_m31():
    x, s = _qm31_samples(7), _m31_samples(8, n=65)
    _eq(f.qm31_mul_m31(_t(x), _t(s)), ref_qm31.mul_m31(x, s))


def test_qm31_inv():
    x = _qm31_samples(9)
    _eq(f.qm31_inv(_t(x)), ref_qm31.inv(x))
    _eq(f.qm31_inv(_t(x[11])), ref_qm31.inv(x[11]))


def test_qm31_embeddings_and_conj():
    a = _m31_samples(10, n=33)
    _eq(f.qm31_from_m31(_t(a)), ref_qm31.from_m31(a))
    _eq(f.qm31_from_ints(5, -1, P + 3, 0), ref_qm31.from_ints(5, -1, P + 3, 0))
    x = _qm31_samples(11)
    _eq(f.qm31_conj(_t(x)), ref_qm31.conj_cm31(x))


def test_u32_round_trip():
    words = np.array([0, 1, P, 0x80000000, 0xFFFFFFFF], dtype=np.uint32)
    t = f.u32_to_tensor(words)
    assert t.dtype == torch.int32
    assert np.array_equal(f.tensor_to_u32(t), words)
    assert np.array_equal(f.tensor_to_u32(f.to_i32(f.to_u32_i64(t))), words)
