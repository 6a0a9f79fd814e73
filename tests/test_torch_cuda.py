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


# ---------------------------------------------------------------------------
# K5 / K6: every component's tape; K7: OODS values.

from luminair_tpu_torch.air import tape  # noqa: E402
from luminair_tpu_torch.air.components import ALL_COMPONENTS  # noqa: E402

COMPONENT_NAMES = [c.name for c in ALL_COMPONENTS]


def _words(rng, n):
    return [tuple(int(x) for x in rng.integers(0, f.P, 4)) for _ in range(n)]


def _ew(rng):
    return [[q for q in _words(rng, 2)] for _ in tape.ELEM_KINDS]


@pytest.mark.parametrize("log", [6, 12])
@pytest.mark.parametrize("name", COMPONENT_NAMES)
def test_air_witness(dev, name, log):
    comp = ALL_COMPONENTS[COMPONENT_NAMES.index(name)]
    tp = tape.record(comp, witness=True)
    rng = np.random.default_rng(COMPONENT_NAMES.index(name) + log)
    main = [_rnd(rng, dev, 1 << log) for _ in comp.MAIN]
    pp = [_rnd(rng, dev, 1 << log) for _ in comp.PP_IDS]
    ew = _ew(rng)
    out, claimed = kernels.air_witness(tp, main, pp, ew)
    ref_out, ref_claimed = tape.witness_plain(tp, main, pp, ew)
    assert torch.equal(out, ref_out)
    assert torch.equal(claimed, ref_claimed)


@pytest.mark.parametrize("log_blowup", [1, 2])
@pytest.mark.parametrize("name", COMPONENT_NAMES)
def test_air_domain(dev, name, log_blowup):
    comp = ALL_COMPONENTS[COMPONENT_NAMES.index(name)]
    tp = tape.record(comp)
    log_trace = 6
    m = 1 << (log_trace + log_blowup)
    rng = np.random.default_rng(100 + COMPONENT_NAMES.index(name) + log_blowup)
    main = [_rnd(rng, dev, m) for _ in comp.MAIN]
    pp = [_rnd(rng, dev, m) for _ in comp.PP_IDS]
    inter = [_rnd(rng, dev, m) for _ in range(4 * tp.n_relations)]
    is_first = _rnd(rng, dev, m)
    claimed, alpha, start = _words(rng, 3)
    ew = _ew(rng)
    pows, _ = f.qm31_powers_ints(start, alpha, tp.n_pows)
    args = (tp, main, pp, inter, is_first, claimed, ew, pows, log_trace, 1 << log_blowup)
    assert torch.equal(kernels.air_domain(*args), tape.domain_plain(*args))
    acc = _rnd(rng, dev, m, 4)
    assert torch.equal(kernels.air_domain(*args, acc=acc.clone()), tape.domain_plain(*args, acc=acc))


@pytest.mark.parametrize("log,C", [(0, 3), (1, 2), (5, 7), (11, 3), (13, 20), (6, 300)])
def test_oods_eval(dev, log, C):
    from luminair_tpu_torch import circle, fft

    rng = np.random.default_rng(log * 1000 + C)
    cols = [_rnd(rng, dev, 1 << log) for _ in range(C)]
    t = torch.from_numpy(rng.integers(0, f.P, 4))
    chain = fft.twiddle_chain(log, circle.point_from_t_qm31(t))
    assert torch.equal(kernels.oods_eval(cols, chain), kernels.oods_eval_plain(cols, chain))


def test_prove_path_never_takes_a_plain_twin(dev, monkeypatch):
    """Every `*_plain` twin raises when a CUDA tensor reaches it; a prove on
    the card then runs through the kernels alone, and each one launches."""
    from luminair_tpu_torch import prelude as T
    from luminair_tpu_torch.crypto import blake2s

    def guard(mod, name):
        fn = getattr(mod, name)

        def checked(*args, **kwargs):
            flat = [a for x in list(args) + list(kwargs.values()) for a in (x if isinstance(x, (list, tuple)) else [x])]
            if any(isinstance(a, torch.Tensor) and a.is_cuda for a in flat):
                raise AssertionError(f"{name} reached with a CUDA tensor")
            return fn(*args, **kwargs)

        monkeypatch.setattr(mod, name, checked)

    for mod in (kernels, tape, blake2s):
        for name in [n for n in dir(mod) if n.endswith("_plain")]:
            guard(mod, name)
    cx = T.Graph()
    rng = np.random.default_rng(0)
    a = cx.tensor((8, 8)).set(rng.normal(size=(8, 8)))
    b = cx.tensor((8, 8)).set(rng.normal(size=(8, 8)))
    (a * b + a).retrieve()
    cx.compile()
    settings = T.gen_circuit_settings(cx)
    kernels.reset_counts()
    T.prove(T.gen_trace(cx, settings), settings, device=dev)
    assert all(v > 0 for v in kernels.counts().values()), kernels.counts()
