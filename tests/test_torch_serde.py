"""The port's files against the reference package's, byte for byte: proof
.npz and JSON, settings JSON and binary, PIE .npz, flat .lmv / .lms; and
round trips both ways (the reference's files read by the port, the port's
read by the reference).  Cases: the a*b + a bench graph at N=8 (blowups
1..4) and N=16, N=8 at both 80-bit profiles, the 2-4-1 tanh PINN and
all_ops, the reference on its host path."""

import numpy as np
import pytest
import torch

from luminair_tpu import prelude as R
from luminair_tpu import serde as ref_serde
from luminair_tpu.air.settings import CircuitSettings as RefSettings
from luminair_tpu.nn import Linear as RefLinear
from luminair_tpu.parallel import accel
from luminair_tpu_torch import prelude as T
from luminair_tpu_torch import serde
from luminair_tpu_torch.air.claim import LuminairClaim, LuminairInteractionClaim
from luminair_tpu_torch.air.pie import LuminairPie
from luminair_tpu_torch.air.settings import CircuitSettings
from luminair_tpu_torch.models import black_scholes as bs
from luminair_tpu_torch.models import op_graphs


def _bench(n):
    def build(pkg):
        cx = pkg.Graph()
        rng = np.random.default_rng(0)
        a = cx.tensor((n, n)).set(rng.normal(size=(n, n)))
        b = cx.tensor((n, n)).set(rng.normal(size=(n, n)))
        (a * b + a).retrieve()
        cx.compile()
        return cx

    return build


PINN_XS = np.array([[0.5, 0.25], [-0.3, 0.1]])


def _pinn_weights():
    """The 2-4-1 network of test_torch_pinn.py (seed 1234)."""
    rng = np.random.default_rng(1234)
    w = {}
    for i, (fan_in, fan_out) in enumerate(((2, 4), (4, 1)), start=1):
        w[f"w{i}"] = rng.normal(scale=1.0 / np.sqrt(fan_in), size=(fan_in, fan_out))
        w[f"b{i}"] = np.zeros(fan_out)
    return w


def _pinn(pkg):
    w = _pinn_weights()
    cx = pkg.Graph()
    if pkg is T:
        x, _ = bs.build(cx, w, batch=PINN_XS.shape[0])
    else:
        l1, l2 = RefLinear(2, 4, True, cx), RefLinear(4, 1, True, cx)
        l1.weight.set(w["w1"])
        l1.bias.set(w["b1"])
        l2.weight.set(w["w2"])
        l2.bias.set(w["b2"])
        x = cx.tensor(PINN_XS.shape)
        l2(l1(x).tanh()).retrieve()
    x.set(PINN_XS)
    cx.compile()
    return cx


def _all_ops(pkg):
    cx = pkg.Graph()
    op_graphs.GRAPHS["all_ops"](cx, op_graphs.DATA)
    cx.compile()
    return cx


def _blowup(b):
    return lambda pkg: pkg.PcsConfig(fri=pkg.FriConfig(log_blowup_factor=b))


def _hs(b):
    return lambda pkg: pkg.PcsConfig.high_security(b)


_bench8 = _bench(8)

#: name -> (graph builder, PcsConfig builder), each taking a package.
CASES = {
    "bench8_b1": (_bench8, _blowup(1)),
    "bench8_b2": (_bench8, _blowup(2)),
    "bench8_b3": (_bench8, _blowup(3)),
    "bench8_b4": (_bench8, _blowup(4)),
    "bench16_b1": (_bench(16), _blowup(1)),
    "bench8_hs1": (_bench8, _hs(1)),
    "bench8_hs2": (_bench8, _hs(2)),
    "pinn": (_pinn, _blowup(1)),
    "all_ops": (_all_ops, _blowup(1)),
}


def make_cases():
    """{case: (reference (settings, pie, proof), port (settings, pie,
    proof))}: the reference on its host path, the port on CPU tensors."""
    out = {}
    was = accel.enabled()
    accel.enable(False)
    try:
        for name, (build, config) in CASES.items():
            cx = build(R)
            settings = R.gen_circuit_settings(cx)
            pie = R.gen_trace(cx, settings)
            out[name] = [(settings, pie, R.prove(pie, settings, config(R)))]
    finally:
        accel.enable(was)
    for name, (build, config) in CASES.items():
        cx = build(T)
        settings = T.gen_circuit_settings(cx, device="cpu")
        pie = T.gen_trace(cx, settings, device="cpu")
        out[name].append((settings, pie, T.prove(pie, settings, config(T), device="cpu")))
    return out


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """These small tensors prove faster on one CPU thread, and the suite's
    workers do not then compete for the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def cases():
    return make_cases()


# Each file kind: (the reference's writer, the port's writer), each taking
# (settings, pie, proof, path).
WRITERS = {
    "proof_npz": (lambda s, pie, p, path: ref_serde.proof_to_file(p, path),
                  lambda s, pie, p, path: serde.proof_to_file(p, path)),
    "proof_json": (lambda s, pie, p, path: ref_serde.proof_to_json_file(p, path),
                   lambda s, pie, p, path: serde.proof_to_json_file(p, path)),
    "settings_json": (lambda s, pie, p, path: s.to_json_file(path), lambda s, pie, p, path: s.to_json_file(path)),
    "settings_bin": (lambda s, pie, p, path: s.to_bin_file(path), lambda s, pie, p, path: s.to_bin_file(path)),
    "pie_npz": (lambda s, pie, p, path: ref_serde.pie_to_file(pie, path),
                lambda s, pie, p, path: serde.pie_to_file(pie, path)),
    "proof_lmv": (lambda s, pie, p, path: ref_serde.proof_to_flat_file(p, path),
                  lambda s, pie, p, path: serde.proof_to_flat_file(p, path)),
    "settings_lms": (lambda s, pie, p, path: ref_serde.settings_to_flat_file(s, path),
                     lambda s, pie, p, path: serde.settings_to_flat_file(s, path)),
}


@pytest.mark.parametrize("kind", list(WRITERS))
@pytest.mark.parametrize("case", list(CASES))
def test_file_equals_reference(cases, tmp_path, case, kind):
    """The port's file of its own settings, PIE (the device interpreter's,
    on CPU tensors) and proof has the reference's bytes."""
    ref_write, port_write = WRITERS[kind]
    ref_write(*cases[case][0], str(tmp_path / "ref"))
    port_write(*cases[case][1], str(tmp_path / "port"))
    assert (tmp_path / "port").read_bytes() == (tmp_path / "ref").read_bytes()


@pytest.mark.parametrize("case", list(CASES))
def test_port_reads_reference_files(cases, tmp_path, case):
    settings, pie, proof = cases[case][0]
    want = ref_serde.proof_to_flat_bytes(proof)
    ref_serde.proof_to_file(proof, str(tmp_path / "p.npz"))
    ref_serde.proof_to_json_file(proof, str(tmp_path / "p.json"))
    assert serde.proof_to_flat_bytes(serde.proof_from_file(str(tmp_path / "p.npz"))) == want
    assert serde.proof_to_flat_bytes(serde.proof_from_json_file(str(tmp_path / "p.json"))) == want
    settings.to_json_file(str(tmp_path / "s.json"))
    settings.to_bin_file(str(tmp_path / "s.bin"))
    want = ref_serde.settings_to_flat_bytes(settings)
    for back in (CircuitSettings.from_json_file(str(tmp_path / "s.json")),
                 CircuitSettings.from_bin_file(str(tmp_path / "s.bin"))):
        assert serde.settings_to_flat_bytes(back) == want


@pytest.mark.parametrize("case", list(CASES))
def test_reference_reads_port_files(cases, tmp_path, case):
    settings, pie, proof = cases[case][1]
    want = serde.proof_to_flat_bytes(proof)
    serde.proof_to_file(proof, str(tmp_path / "p.npz"))
    serde.proof_to_json_file(proof, str(tmp_path / "p.json"))
    assert ref_serde.proof_to_flat_bytes(ref_serde.proof_from_file(str(tmp_path / "p.npz"))) == want
    assert ref_serde.proof_to_flat_bytes(ref_serde.proof_from_json_file(str(tmp_path / "p.json"))) == want
    settings.to_json_file(str(tmp_path / "s.json"))
    settings.to_bin_file(str(tmp_path / "s.bin"))
    want = serde.settings_to_flat_bytes(settings)
    for back in (RefSettings.from_json_file(str(tmp_path / "s.json")),
                 RefSettings.from_bin_file(str(tmp_path / "s.bin"))):
        assert ref_serde.settings_to_flat_bytes(back) == want
    serde.pie_to_file(pie, str(tmp_path / "pie.npz"))
    back = ref_serde.pie_from_file(str(tmp_path / "pie.npz"))
    assert back.to_dict() == cases[case][0][1].to_dict()


@pytest.mark.parametrize("case", list(CASES))
def test_port_proves_reference_pie_file(cases, tmp_path, case):
    """A PIE and settings the reference wrote, read by the port and proved
    on the CPU: the reference's proof bytes."""
    settings, pie, proof = cases[case][0]
    ref_serde.pie_to_file(pie, str(tmp_path / "pie.npz"))
    settings.to_bin_file(str(tmp_path / "s.bin"))
    port_pie = serde.pie_from_file(str(tmp_path / "pie.npz"))
    assert all(isinstance(v, np.ndarray) and v.dtype == np.uint32
               for t in port_pie.trace_tables.values() for v in t.columns.values())
    got = T.prove(port_pie, CircuitSettings.from_bin_file(str(tmp_path / "s.bin")), CASES[case][1](T), device="cpu")
    assert serde.proof_to_flat_bytes(got) == ref_serde.proof_to_flat_bytes(proof)


@pytest.mark.parametrize("case", list(CASES))
def test_dicts_match_reference(cases, case):
    """Claims, PIE and payload in dict form equal the reference's, and come
    back through from_dict; the device interpreter's PIE (int32 views on
    CPU tensors) gives the host form."""
    (_, ref_pie, ref_proof), (_, pie, proof) = cases[case]
    assert any(isinstance(v, torch.Tensor) for t in pie.trace_tables.values() for v in t.columns.values())
    assert pie.to_dict() == ref_pie.to_dict()
    assert LuminairPie.from_dict(pie.to_dict()).to_dict() == ref_pie.to_dict()
    assert proof.claim.to_dict() == ref_proof.claim.to_dict()
    assert LuminairClaim.from_dict(proof.claim.to_dict()) == proof.claim
    assert proof.interaction_claim.to_dict() == ref_proof.interaction_claim.to_dict()
    sums = LuminairInteractionClaim.from_dict(proof.interaction_claim.to_dict()).sums
    assert {k: v.tolist() for k, v in sums.items()} == ref_proof.interaction_claim.to_dict()
    back = serde.proof_from_payload(ref_serde.proof_to_payload(ref_proof))
    assert serde.proof_to_flat_bytes(back) == ref_serde.proof_to_flat_bytes(ref_proof)
    assert all(w.dtype == np.uint32 and w.shape[1:] == (8,) for w in back.pcs_proof.tree_witnesses)


def test_read_rejects_a_file_of_another_kind(cases, tmp_path):
    from luminair_tpu_torch.errors import SerializationError

    settings, pie, proof = cases["bench8_b1"][1]
    serde.proof_to_file(proof, str(tmp_path / "p.npz"))
    serde.pie_to_file(pie, str(tmp_path / "pie.npz"))
    with pytest.raises(SerializationError):
        serde.pie_from_file(str(tmp_path / "p.npz"))
    with pytest.raises(SerializationError):
        serde.proof_from_file(str(tmp_path / "pie.npz"))
    with pytest.raises(SerializationError):
        CircuitSettings.from_bin_file(str(tmp_path / "p.npz"))
