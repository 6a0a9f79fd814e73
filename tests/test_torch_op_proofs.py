"""Whole proofs of the six op graphs (models/op_graphs.py) and of a small
PINN at log blowups above 1: the port's proof on the CPU, from its device
interpreter's PIE of CPU tensors, must equal the reference's host proof
byte for byte.  Every graph at blowups 1 and 2, the four small graphs
(tables of at most 2^8 rows) at 3 and 4 as well; all_ops and mlp, whose
sin / exp2 tables take 2^14 rows, prove in 8-22 s each at 3-4 and are
left to the card (chip_smoke.py, phase op_graph_blowup); the 2-4-1 PINN
at blowup 2."""

import numpy as np
import pytest
import torch

from luminair_tpu import prelude as R
from luminair_tpu import serde as ref_serde
from luminair_tpu.parallel import accel
from luminair_tpu_torch import prelude as T
from luminair_tpu_torch import serde
from luminair_tpu_torch.models import black_scholes as bs
from luminair_tpu_torch.models import op_graphs
from tests import test_device_trace as ref_graphs
from tests.test_torch_pinn import XS, _reference_graph, _small_weights

LARGE = ("all_ops", "mlp")
CASES = ([(g, b) for g in op_graphs.GRAPHS for b in (1, 2)]
         + [(g, b) for g in op_graphs.GRAPHS if g not in LARGE for b in (3, 4)] + [("pinn", 2)])


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """These small tensors prove faster on one CPU thread, and the suite's
    workers do not then compete for the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def traced():
    """{graph: (reference PIE, settings, port PIE, settings)}: the reference
    on its host interpreter, the port on its device interpreter with CPU
    tensors."""
    out = {}
    for name in [*op_graphs.GRAPHS, "pinn"]:
        if name == "pinn":
            rcx = _reference_graph(_small_weights())
            cx = T.Graph()
            x, _ = bs.build(cx, _small_weights(), batch=XS.shape[0])
            x.set(XS)
        else:
            rcx = R.Graph()
            getattr(ref_graphs, "build_" + name)(rcx, ref_graphs.DATA)
            rcx.compile()
            cx = T.Graph()
            op_graphs.GRAPHS[name](cx, op_graphs.DATA)
        cx.compile()
        rs = R.gen_circuit_settings(rcx, device=False)
        settings = T.gen_circuit_settings(cx, device="cpu")
        out[name] = (R.gen_trace(rcx, rs, device=False), rs, T.gen_trace(cx, settings, device="cpu"), settings)
    return out


@pytest.mark.parametrize("name,log_blowup", CASES)
def test_proof_bytes_match_reference(traced, name, log_blowup):
    rp, rs, pie, settings = traced[name]
    was = accel.enabled()
    accel.enable(False)
    try:
        want = ref_serde.proof_to_flat_bytes(R.prove(rp, rs, R.PcsConfig(fri=R.FriConfig(log_blowup_factor=log_blowup))))
    finally:
        accel.enable(was)
    proof = T.prove(pie, settings, T.PcsConfig(fri=T.FriConfig(log_blowup_factor=log_blowup)), device="cpu")
    assert proof.config.fri.log_blowup_factor == log_blowup
    assert serde.proof_to_flat_bytes(proof) == want


def test_small_graphs_stay_small(traced):
    """The graphs proved at blowups 3-4 here keep their tables at 2^8 rows
    or fewer; the two left out are the ones that do not."""
    for name in op_graphs.GRAPHS:
        top = max(t.log_size for t in traced[name][2].trace_tables.values() if t.n_rows)
        assert (top > 8) == (name in LARGE), (name, top)
