"""The port's CUDA kernels against their plain twins, on the card.

These need a CUDA device and nvcc; elsewhere they skip.  On the card (the
shared conftest imports JAX, which these tests do not need):
    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from luminair_tpu_torch import fields as f
from luminair_tpu_torch import kernels

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _rnd(rng, dev, *shape):
    return torch.from_numpy(rng.integers(0, f.P, size=shape).astype(np.int32)).to(dev)


@pytest.mark.parametrize("log", [1, 2, 7, 12])
def test_circle_fft(dev, log):
    rng = np.random.default_rng(log)
    v = _rnd(rng, dev, 3, 1 << log)
    assert torch.equal(kernels.circle_ifft(v), kernels.circle_ifft_plain(v))
    assert torch.equal(kernels.circle_fft(v), kernels.circle_fft_plain(v))
    for b in (1, 2, 3, 4):
        assert torch.equal(kernels.circle_lde(v, b), kernels.circle_lde_plain(v, b))


@pytest.mark.parametrize("k,log", [(0, 3), (3, 4), (25, 6)])
def test_merkle_layer(dev, k, log):
    rng = np.random.default_rng(k)
    prev = _rnd(rng, dev, 2 << log, 8)
    cols = _rnd(rng, dev, k, 1 << log) if k else None
    assert torch.equal(kernels.merkle_layer(prev, cols), kernels.merkle_layer_plain(prev, cols))
    if cols is not None:
        assert torch.equal(kernels.merkle_layer(None, cols), kernels.merkle_layer_plain(None, cols))


@pytest.mark.parametrize("log", [1, 6, 12])
def test_fri_fold(dev, log):
    rng = np.random.default_rng(log)
    v, tw, mix = _rnd(rng, dev, 1 << log, 4), _rnd(rng, dev, 1 << (log - 1)), _rnd(rng, dev, 1 << (log - 1), 4)
    a, b2 = rng.integers(0, f.P, 4), rng.integers(0, f.P, 4)
    assert torch.equal(kernels.fri_fold(v, tw, a), kernels.fri_fold_plain(v, tw, a))
    assert torch.equal(kernels.fri_fold(v, tw, a, mix, b2), kernels.fri_fold_plain(v, tw, a, mix, b2))


@pytest.mark.parametrize("log,S", [(3, 1), (10, 7)])
def test_deep_quotient(dev, log, S):
    rng = np.random.default_rng(S)
    cols = [_rnd(rng, dev, 1 << log) for _ in range(S)]
    g = torch.from_numpy(rng.integers(0, f.P, (S, 4)))
    c = torch.from_numpy(rng.integers(0, f.P, (5, 4)))
    acc = _rnd(rng, dev, 1 << log, 4)
    assert torch.equal(kernels.deep_quotient(cols, g, c, log), kernels.deep_quotient_plain(cols, g, c, log))
    assert torch.equal(
        kernels.deep_quotient(cols, g, c, log, acc.clone()), kernels.deep_quotient_plain(cols, g, c, log, acc)
    )
