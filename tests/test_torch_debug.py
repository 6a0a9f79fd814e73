"""The port's constraint check (luminair_tpu_torch/air/debug.py,
`check_pie_constraints`, and the tape twin `tape.check_plain`) against the
reference package's (luminair_tpu/air/debug.py) on the CPU: the same dict,
element for element, for every op graph, for the reference's PIEs, for PIEs
with one cell changed and for the two round-5 forgeries of VERDICT.md; a
PIE of CPU tensors and its host form give the same dicts; the twin's mask
equals a direct per-constraint evaluation of every component."""

import copy

import numpy as np
import pytest
import torch

from luminair_tpu import prelude as R
from luminair_tpu.air import debug as ref_debug
from luminair_tpu.air.components import ALL_COMPONENTS as REF_COMPONENTS
from luminair_tpu.air.framework import WitnessEval
from luminair_tpu.parallel import accel
from luminair_tpu_torch import fields as f
from luminair_tpu_torch import kernels
from luminair_tpu_torch import prelude as T
from luminair_tpu_torch.air import tape
from luminair_tpu_torch.air.components import ALL_COMPONENTS
from luminair_tpu_torch.air.debug import check_pie_constraints
from luminair_tpu_torch.air.pie import LuminairPie, TraceTable
from luminair_tpu_torch.air.settings import CircuitSettings
from luminair_tpu_torch.errors import KernelError
from luminair_tpu_torch.models import op_graphs
from tests import test_device_trace as ref_graphs
from tests.test_torch_air import _elements, _port_elems, _ref_elems
from tests.test_torch_verifier import _binary, _less_than_forgery, _lt_graph, _mul_forgery

P = (1 << 31) - 1
GRAPHS = list(op_graphs.GRAPHS)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """These small tensors check faster on one CPU thread, and the suite's
    workers do not then compete for the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def host_reference():
    was = accel.enabled()
    accel.enable(False)
    yield
    accel.enable(was)


def _traced(ref_build, port_build):
    """(reference PIE, reference settings, port PIE of CPU tensors, port
    settings) of one graph, each package on its own interpreter."""
    rcx = R.Graph()
    ref_build(rcx)
    rcx.compile()
    rs = R.gen_circuit_settings(rcx, device=False)
    cx = T.Graph()
    port_build(cx)
    cx.compile()
    settings = T.gen_circuit_settings(cx, device="cpu")
    return R.gen_trace(rcx, rs, device=False), rs, T.gen_trace(cx, settings, device="cpu"), settings


@pytest.fixture(scope="module")
def graphs():
    return {name: _traced(lambda cx: getattr(ref_graphs, "build_" + name)(cx, ref_graphs.DATA),
                          lambda cx: op_graphs.GRAPHS[name](cx, op_graphs.DATA)) for name in GRAPHS}


def _host_form(pie):
    """A PIE of CPU tensors as uint32 numpy columns, n_rows long."""
    return LuminairPie({k: TraceTable(k, t.host_columns()) for k, t in pie.trace_tables.items()}, pie.metadata)


def _port_form(ref_pie):
    """The reference's PIE as the port's host PIE."""
    return LuminairPie({k: TraceTable(k, {c: np.asarray(v, dtype=np.uint32) for c, v in t.columns.items()})
                        for k, t in ref_pie.trace_tables.items()}, None)


def _with_columns(pie, host):
    """A copy of a PIE of CPU tensors whose first n_rows of each column are
    `host`'s (its padding rows kept)."""
    tables = {}
    for k, t in pie.trace_tables.items():
        padded = {c: v.clone() for c, v in t.padded.items()}
        n = t.n_rows
        for c, v in host.trace_tables[k].columns.items():
            padded[c][:n] = f.u32_to_tensor(v)
        tables[k] = TraceTable(k, {c: padded[c][:n] for c in t.columns}, padded)
    return LuminairPie(tables, pie.metadata)


@pytest.mark.parametrize("name", GRAPHS)
def test_honest_graph_matches_reference(graphs, name):
    rp, rs, pie, settings = graphs[name]
    assert ref_debug.check_pie_constraints(rp, rs) == {}
    assert check_pie_constraints(pie, settings, device="cpu") == {}
    assert check_pie_constraints(_host_form(pie), settings, device="cpu") == {}
    assert check_pie_constraints(_port_form(rp), CircuitSettings.from_dict(rs.to_dict()), device="cpu") == {}


def _cell(table, column, row):
    def mutate(pie, settings):
        col = np.asarray(pie.trace_tables[table].columns[column], dtype=np.uint32).copy()
        col[row] = (int(col[row]) + 1) % P
        pie.trace_tables[table].columns[column] = col

    return mutate


def _op_graph(name):
    return (lambda cx: getattr(ref_graphs, "build_" + name)(cx, ref_graphs.DATA),
            lambda cx: op_graphs.GRAPHS[name](cx, op_graphs.DATA))


def _seeded(build):
    return (lambda cx: build(cx, np.random.default_rng(23)),) * 2


#: name -> (reference graph, port graph, mutation of a host PIE, the
#: reference's dict where it was read off the reference beforehand).
MUTATIONS = {
    "mul_out_row_3": (*_op_graph("all_ops"), _cell("mul", "out", 3), {"mul": [(1, [3])]}),
    "mul_out_row_5": (*_op_graph("all_ops"), _cell("mul", "out", 5), {"mul": [(1, [5])]}),
    "mul_lhs_row_0": (*_op_graph("all_ops"), _cell("mul", "lhs", 0), None),
    "add_out_row_7": (*_op_graph("all_ops"), _cell("add", "out", 7), None),
    # A per-component check cannot see an imbalance between components.
    "mul_out_mult": (*_op_graph("all_ops"), _cell("mul", "out_mult", 0), {}),
    "sin_lookup_multiplicity": (*_op_graph("all_ops"), _cell("sin_lookup", "multiplicity", 5), None),
    "less_than_diff": (*_op_graph("all_ops"), _cell("less_than", "diff", 1), None),
    "rem_rem": (*_op_graph("all_ops"), _cell("rem", "rem", 2), None),
    "max_reduce_max_val": (*_op_graph("reduce_axes"), _cell("max_reduce", "max_val", 4), None),
    "sum_reduce_acc": (*_op_graph("mlp"), _cell("sum_reduce", "acc", 9), None),
    "forgery_less_than_borrow": (*_seeded(_lt_graph), _less_than_forgery, None),
    "forgery_mul_remainder": (*_seeded(_binary("mul")), _mul_forgery, None),
}


@pytest.mark.parametrize("name", list(MUTATIONS))
def test_mutated_pie_matches_reference(name):
    """The same mutation of the reference's PIE and of the port's host form:
    the reference's dict, from the port's check of the host form, of the
    PIE of CPU tensors carrying the same words, and of the reference's own
    mutated PIE."""
    ref_build, port_build, mutate, want = MUTATIONS[name]
    rp, rs, pie, settings = _traced(ref_build, port_build)
    mutate(rp, rs)
    host = _host_form(pie)
    mutate(host, settings)
    expect = ref_debug.check_pie_constraints(rp, rs)
    if want is not None:
        assert expect == want
    assert check_pie_constraints(host, settings, device="cpu") == expect
    assert check_pie_constraints(_with_columns(pie, host), settings, device="cpu") == expect
    assert check_pie_constraints(_port_form(rp), CircuitSettings.from_dict(rs.to_dict()), device="cpu") == expect


def test_components_without_rows_are_left_out(graphs):
    rp, rs, pie, settings = graphs["broadcast"]
    ref_pie, host = copy.deepcopy(rp), _host_form(pie)
    for p in (ref_pie, host):
        p.trace_tables["square"].columns = {c: v[:0] for c, v in p.trace_tables["square"].columns.items()}
    _cell("mul", "out", 1)(ref_pie, rs)
    _cell("mul", "out", 1)(host, settings)
    expect = ref_debug.check_pie_constraints(ref_pie, rs)
    assert "square" not in expect and expect == {"mul": [(1, [1])]}
    assert check_pie_constraints(host, settings, device="cpu") == expect


class _Values(ref_debug._CheckEval):
    """The reference's trace-domain evaluator, keeping every constraint's
    nonzero rows in full."""

    def __init__(self, *args):
        super().__init__(*args)
        self.nonzero = []

    def constraint(self, expr):
        v = np.asarray(expr.v)
        self.nonzero.append(np.any(np.broadcast_to(v, (self.n_rows, 4)) != 0, axis=-1))


NAMES = [c.name for c in ALL_COMPONENTS]


@pytest.mark.parametrize("name", NAMES)
def test_check_plain_matches_direct_evaluation(name):
    """Main columns of small words (0, 1, 2: many constraints vanish on
    some rows and not on others), the interaction built honestly and then
    changed on a few rows; the twin's mask bit i at row r is set exactly
    when the reference's evaluator finds constraint i nonzero at r."""
    comp = next(c for c in ALL_COMPONENTS if c.name == name)
    ref = next(c for c in REF_COMPONENTS if c.name == name)
    rng = np.random.default_rng(300 + NAMES.index(name))
    n = 1 << 6
    main = {c: rng.integers(0, 3, size=n).astype(np.uint32) for c in comp.MAIN}
    pp = {p: rng.integers(0, 3, size=n).astype(np.uint32) for p in comp.PP_IDS}
    raw = _elements(rng)
    wev = WitnessEval(main, pp)
    ref.evaluate(wev, _ref_elems(raw))
    inter, claimed = wev.build_interaction()
    inter = [np.array(q, dtype=np.uint32) for q in inter]
    for q in inter:
        q[rng.integers(0, n, size=3), rng.integers(0, 4, size=3)] ^= 1
    chk = _Values(main, pp, inter, claimed)
    ref.evaluate(chk, _ref_elems(raw))
    want = sum(v.astype(np.int64) << i for i, v in enumerate(chk.nonzero))

    tp = tape.record(comp)
    assert len(chk.nonzero) == tp.n_pows
    is_first = np.zeros(n, dtype=np.uint32)
    is_first[0] = 1
    args = (tp, [f.u32_to_tensor(main[c]) for c in comp.MAIN], [f.u32_to_tensor(pp[p]) for p in comp.PP_IDS],
            [f.u32_to_tensor(np.ascontiguousarray(q[:, k])) for q in inter for k in range(4)],
            f.u32_to_tensor(is_first), claimed, tape.element_words(_port_elems(raw)))
    got = kernels.air_check(*args)
    assert got.dtype == torch.int32
    assert np.array_equal(f.tensor_to_u32(got).astype(np.int64), want)
    assert torch.equal(got, tape.check_plain(*args[:5], f.qm31_words(claimed), args[6]))
    # The data sets some constraint's bit on some rows and not on others.
    assert any(0 < v.sum() < n for v in chk.nonzero)


def test_air_check_refuses_what_it_cannot_take():
    comp = ALL_COMPONENTS[0]
    tp = tape.record(comp)
    n = 8
    cols = [torch.zeros(n, dtype=torch.int32) for _ in comp.MAIN]
    inter = [torch.zeros(n, dtype=torch.int32) for _ in range(4 * tp.n_relations)]
    is_first = torch.zeros(n, dtype=torch.int32)
    ew = [[(0,) * 4] * 2 for _ in tape.ELEM_KINDS]
    with pytest.raises(KernelError):
        kernels.air_check(tp, cols[:-1], [], inter, is_first, (0,) * 4, ew)
    with pytest.raises(KernelError):
        kernels.air_check(tp, cols, [], inter, is_first[:6], (0,) * 4, ew)
    with pytest.raises(KernelError):
        kernels.air_check(tp, cols, [], inter, is_first.to(torch.int64), (0,) * 4, ew)
