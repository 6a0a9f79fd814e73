"""The port's examples (examples/torch_*.py) run on the CPU against the
reference package's: the same printed results, and proofs with the same
bytes as the reference's host proofs of the same graphs.  torch_simple's
files round-trip under build/examples/; the reference's examples/out/
keeps its bytes."""

import hashlib
import os

import numpy as np
import pytest
import torch

from examples import risk_assessment as ref_risk
from examples import torch_black_scholes_nn, torch_risk_assessment, torch_simple
from luminair_tpu import prelude as R
from luminair_tpu import serde as ref_serde
from luminair_tpu.parallel import accel
from luminair_tpu_torch import serde
from luminair_tpu_torch.air.settings import CircuitSettings
from luminair_tpu.nn import Linear as RefLinear
from tests.test_torch_pinn import XS, _small_weights

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_OUT = os.path.join(ROOT, "examples", "out")


def _digests():
    return {n: hashlib.sha256(open(os.path.join(REF_OUT, n), "rb").read()).hexdigest()
            for n in sorted(os.listdir(REF_OUT))}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """These small tensors prove faster on one CPU thread, and the suite's
    workers do not then compete for the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def ref_out_before():
    return _digests()


@pytest.fixture(autouse=True)
def host_reference():
    """The reference on its host path."""
    was = accel.enabled()
    accel.enable(False)
    yield
    accel.enable(was)


def test_simple_matches_reference(ref_out_before):
    """The reference example's graph (examples/simple.py), proved on the
    reference's host path: the same output line and proof bytes; the
    port's files under build/examples/ read back to the same bytes."""
    cx = R.Graph()
    a = cx.tensor((2, 2)).set([[1.0, 2.0], [3.0, 4.0]])
    b = cx.tensor((2, 2)).set([[10.0, 20.0], [30.0, 40.0]])
    c = (a * b + a).retrieve()
    cx.compile()
    rs = R.gen_circuit_settings(cx)
    want = ref_serde.proof_to_flat_bytes(R.prove(R.gen_trace(cx, rs), rs))

    got = torch_simple.main(device="cpu")
    assert got["printed"][2] == f"output: {c.data().tolist()}"
    assert got["printed"][3] == "serialized proof re-verified OK"
    assert serde.proof_to_flat_bytes(got["proof"]) == want
    proof_path, settings_path = got["files"]
    assert os.path.dirname(proof_path) == os.path.dirname(settings_path) == os.path.join(ROOT, "build", "examples")
    assert serde.proof_to_flat_bytes(serde.proof_from_file(proof_path)) == want
    assert (serde.settings_to_flat_bytes(CircuitSettings.from_json_file(settings_path))
            == ref_serde.settings_to_flat_bytes(rs))


def test_risk_assessment_matches_reference(monkeypatch, capsys):
    """The reference example's main() on its host path, its proof kept:
    the port prints the same VaR, CVaR and max-loss lines, and its proof
    has the same bytes."""
    proofs = []

    def keep(*args, **kw):
        proofs.append(R.prove(*args, **kw))
        return proofs[-1]

    monkeypatch.setattr(ref_risk, "prove", keep)
    ref_risk.main()
    ref_lines = capsys.readouterr().out.splitlines()
    got = torch_risk_assessment.main(device="cpu")
    assert got["printed"][:3] == ref_lines[:3]
    assert [round(float(got[k]), 2) for k in ("var", "cvar", "max_loss")] == [39.8, 43.42, 48.0]
    assert serde.proof_to_flat_bytes(got["proof"]) == ref_serde.proof_to_flat_bytes(proofs[0])


def test_black_scholes_runs_the_small_network():
    """main() with the 2-4-1 network and inputs of test_torch_pinn.py: the
    reference's host proof bytes of that network, its outputs, and a price
    line from them."""
    w = _small_weights()
    rcx = R.Graph()
    l1, l2 = RefLinear(2, 4, True, rcx), RefLinear(4, 1, True, rcx)
    for layer, i in ((l1, 1), (l2, 2)):
        layer.weight.set(w[f"w{i}"])
        layer.bias.set(w[f"b{i}"])
    x = rcx.tensor(XS.shape)
    out = l2(l1(x).tanh()).retrieve()
    x.set(XS)
    rcx.compile()
    rs = R.gen_circuit_settings(rcx)
    want = ref_serde.proof_to_flat_bytes(R.prove(R.gen_trace(rcx, rs), rs))
    ref_out = np.asarray(out.data(), dtype=np.float64).reshape(-1)

    got = torch_black_scholes_nn.main(device="cpu", weights=w, x=XS)
    assert serde.proof_to_flat_bytes(got["proof"]) == want
    assert np.array_equal(got["outputs"], ref_out)
    expect = (np.tanh(XS @ w["w1"] + w["b1"]) @ w["w2"] + w["b2"]).reshape(-1)
    assert np.array_equal(got["reference"], expect)
    assert got["printed"][-1] == f"Predicted option price: {ref_out[0]:.6f} (float reference {expect[0]:.6f})"


def test_examples_leave_the_reference_output_alone(ref_out_before):
    assert _digests() == ref_out_before
