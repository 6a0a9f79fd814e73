"""The recorded component tapes (luminair_tpu_torch.air.tape) against the
reference package's host interpreters, for every component: the plain
witness interpreter against `WitnessEval.build_interaction`, the plain
domain interpreter against `DomainEval` at blowups 1 and 2.  Every
comparison is exact."""

import numpy as np
import pytest
import torch

from luminair_tpu import circle as ref_circle
from luminair_tpu.air import framework as ref_fw
from luminair_tpu.air.components import ALL_COMPONENTS as REF_COMPONENTS
from luminair_tpu.fields import m31 as ref_m31
from luminair_tpu_torch import fields as f
from luminair_tpu_torch.air import tape
from luminair_tpu_torch.air.components import ALL_COMPONENTS
from luminair_tpu_torch.air.framework import LookupElements

P = (1 << 31) - 1
LOG = 6
NAMES = [c.name for c in ALL_COMPONENTS]


def _words(rng, *shape):
    return rng.integers(0, P, size=shape, dtype=np.int64).astype(np.uint32)


def _elements(rng):
    """The same drawn elements for both packages: {kind: (z, alpha, size)}."""
    sizes = {"node": 2, "sin": 2, "exp2": 2, "log2": 2, "range_check": 1}
    return {k: (_words(rng, 4), _words(rng, 4), s) for k, s in sizes.items()}


def _ref_elems(raw):
    return {k: ref_fw.LookupElements(z, a, s) for k, (z, a, s) in raw.items()}


def _port_elems(raw):
    return {k: LookupElements(f.u32_to_tensor(z, dtype=f.I64), f.u32_to_tensor(a, dtype=f.I64), s)
            for k, (z, a, s) in raw.items()}


def _pair(name):
    comp = next(c for c in ALL_COMPONENTS if c.name == name)
    ref = next(c for c in REF_COMPONENTS if c.name == name)
    assert comp.MAIN == ref.MAIN and list(comp.PP_IDS) == list(ref.PP_IDS)
    return comp, ref


def _t(a):
    return f.u32_to_tensor(a)


def test_every_component_records():
    assert len(ALL_COMPONENTS) == 18
    for comp in ALL_COMPONENTS:
        tp = tape.record(comp)
        assert tp.n_relations == comp.N_INTERACTION
        assert tp.n_regs <= tape.MAX_REGS and tp.n_pows <= tape.MAX_POWS
        assert tape.record(comp) is tp


def test_constants_reduce_mod_p():
    """less_than's borrow coefficient 2^31 - 1 is recorded as 0, as the
    reference's qm31.from_ints reduces it."""
    comp = next(c for c in ALL_COMPONENTS if c.name == "less_than")
    consts = [a for op, _, a, _, _ in tape.record(comp).instructions() if op == tape.OP_CONST]
    assert 0 in consts and all(0 <= a < P for a in consts)


@pytest.mark.parametrize("name", NAMES)
def test_witness_matches_reference(name):
    comp, ref = _pair(name)
    rng = np.random.default_rng(NAMES.index(name))
    n = 1 << LOG
    main = {c: _words(rng, n) for c in comp.MAIN}
    pp = {p: _words(rng, n) for p in comp.PP_IDS}
    raw = _elements(rng)

    wev = ref_fw.WitnessEval(main, pp)
    ref.evaluate(wev, _ref_elems(raw))
    ref_cols, ref_claimed = wev.build_interaction()

    tp = tape.record(comp, witness=True)
    assert tp.n_constraints == 0 and tp.n_relations == comp.N_INTERACTION
    out, claimed = tape.witness_plain(
        tp, [_t(main[c]) for c in comp.MAIN], [_t(pp[p]) for p in comp.PP_IDS],
        tape.element_words(_port_elems(raw)),
    )
    assert tuple(out.shape) == (4 * comp.N_INTERACTION, n)
    expect = np.concatenate([np.asarray(q, dtype=np.uint32).T for q in ref_cols])
    assert np.array_equal(f.tensor_to_u32(out), expect)
    assert np.array_equal(f.tensor_to_u32(claimed), np.asarray(ref_claimed, dtype=np.uint32))


@pytest.mark.parametrize("log_blowup", [1, 2])
@pytest.mark.parametrize("name", NAMES)
def test_domain_matches_reference(name, log_blowup):
    comp, ref = _pair(name)
    rng = np.random.default_rng(100 + NAMES.index(name) + 50 * log_blowup)
    eval_log = LOG + log_blowup
    m = 1 << eval_log
    main = {c: _words(rng, m) for c in comp.MAIN}
    pp = {p: _words(rng, m) for p in comp.PP_IDS}
    inter = [_words(rng, m, 4) for _ in range(comp.N_INTERACTION)]
    is_first = _words(rng, m)
    claimed = _words(rng, 4)
    alpha = _words(rng, 4)
    acc_pow = _words(rng, 4)
    raw = _elements(rng)

    acc = ref_fw.ConstraintAccumulator(alpha, (m,))
    acc._pow = acc_pow
    dev = ref_fw.DomainEval(main, pp, inter, is_first, claimed, acc, roll_stride=1 << log_blowup)
    ref.evaluate(dev, _ref_elems(raw))
    xs, _ = ref_circle.domain_points(eval_log)
    vinv = ref_m31.inv(ref_circle.coset_vanishing_eval(xs, LOG, eval_log))
    ref_q = ref_m31.mul(acc.acc, vinv[:, None])

    tp = tape.record(comp)
    pows, next_pow = f.qm31_powers_ints(f.qm31_words(acc_pow), f.qm31_words(alpha), tp.n_pows)
    q = tape.domain_plain(
        tp, [_t(main[c]) for c in comp.MAIN], [_t(pp[p]) for p in comp.PP_IDS],
        [_t(np.ascontiguousarray(e[:, k])) for e in inter for k in range(4)],
        _t(is_first), f.qm31_words(claimed), tape.element_words(_port_elems(raw)), pows,
        LOG, 1 << log_blowup,
    )
    assert np.array_equal(f.tensor_to_u32(q), np.asarray(ref_q, dtype=np.uint32))
    assert next_pow == f.qm31_words(acc._pow)

    base = _t(_words(rng, m, 4))
    q_acc = tape.domain_plain(
        tp, [_t(main[c]) for c in comp.MAIN], [_t(pp[p]) for p in comp.PP_IDS],
        [_t(np.ascontiguousarray(e[:, k])) for e in inter for k in range(4)],
        _t(is_first), f.qm31_words(claimed), tape.element_words(_port_elems(raw)), pows,
        LOG, 1 << log_blowup, acc=base,
    )
    assert torch.equal(q_acc, f.add(base.to(f.I64), q.to(f.I64)).to(f.I32))
