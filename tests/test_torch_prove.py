"""End to end: the a*b + a bench graph through luminair_tpu_torch on the CPU,
byte for byte against the reference package's host proof, accepted by the
reference verifier."""

import copy

import numpy as np
import pytest

from luminair_tpu import prelude as R
from luminair_tpu import serde as ref_serde
from luminair_tpu.errors import LuminairError as RefLuminairError
from luminair_tpu.parallel import accel
from luminair_tpu.verifier import verify as ref_verify
from luminair_tpu_torch import prelude as T
from luminair_tpu_torch import serde
from luminair_tpu_torch.air.pie import pie_from_arrays
from luminair_tpu_torch.air.settings import settings_from_dict
from luminair_tpu_torch.errors import ProverError

CASES = [(8, 1), (16, 1), (8, 2), (8, 3), (8, 4)]


def _graph(pkg, n):
    cx = pkg.Graph()
    rng = np.random.default_rng(0)
    a = cx.tensor((n, n)).set(rng.normal(size=(n, n)))
    b = cx.tensor((n, n)).set(rng.normal(size=(n, n)))
    (a * b + a).retrieve()
    cx.compile()
    return cx


def _config(pkg, log_blowup):
    return pkg.PcsConfig(fri=pkg.FriConfig(log_blowup_factor=log_blowup))


@pytest.fixture(scope="module")
def reference():
    """{(n, B): (ref pie, ref settings, ref proof, ref flat bytes)} on the
    reference's host path (the device engine off, restored afterwards)."""
    was = accel.enabled()
    accel.enable(False)
    try:
        out = {}
        for n, B in CASES:
            cx = _graph(R, n)
            settings = R.gen_circuit_settings(cx)
            pie = R.gen_trace(cx, settings)
            proof = R.prove(pie, settings, _config(R, B))
            out[(n, B)] = (pie, settings, proof, ref_serde.proof_to_flat_bytes(proof))
        return out
    finally:
        accel.enable(was)


@pytest.mark.parametrize("n", [8, 16])
def test_gen_trace_matches_reference(reference, n):
    ref_pie, ref_settings = reference[(n, 1)][:2]
    cx = _graph(T, n)
    settings = T.gen_circuit_settings(cx)
    pie = T.gen_trace(cx, settings)
    assert settings.to_dict() == ref_settings.to_dict()
    assert sorted(pie.trace_tables) == sorted(ref_pie.trace_tables)
    for name, t in pie.trace_tables.items():
        ref_t = ref_pie.trace_tables[name]
        assert t.log_size == ref_t.log_size
        assert list(t.columns) == list(ref_t.columns)
        for col, v in t.columns.items():
            assert np.array_equal(v, ref_t.columns[col]), (name, col)


@pytest.mark.parametrize("n,log_blowup", CASES)
def test_proof_bytes_match_reference(reference, n, log_blowup):
    ref_bytes = reference[(n, log_blowup)][3]
    cx = _graph(T, n)
    settings = T.gen_circuit_settings(cx)
    proof = T.prove(T.gen_trace(cx, settings), settings, _config(T, log_blowup), device="cpu")
    assert serde.proof_to_flat_bytes(proof) == ref_bytes
    assert serde.settings_to_flat_bytes(settings) == ref_serde.settings_to_flat_bytes(reference[(n, 1)][1])


def _payload(proof) -> dict:
    """The port's proof in the reference's plain payload form
    (luminair_tpu.serde.proof_from_payload reads it)."""
    p, fp = proof.pcs_proof, proof.pcs_proof.fri_proof
    return {
        "claim": dict(proof.claim.log_sizes),
        "interaction_claim": {k: np.asarray(v).tolist() for k, v in proof.interaction_claim.sums.items()},
        "roots": list(proof.roots),
        "config": proof.config.to_dict(),
        "pcs": {
            "sampled_values": p.sampled_values,
            "pow_nonce": p.pow_nonce,
            "tree_queried_values": p.tree_queried_values,
            "tree_witnesses": p.tree_witnesses,
            "fri": {
                "layer_roots": fp.layer_roots,
                "layer_queried_values": fp.layer_queried_values,
                "layer_witnesses": fp.layer_witnesses,
                "last_layer_coeffs": fp.last_layer_coeffs,
                "pow_nonce": fp.pow_nonce,
            },
        },
    }


def _port_proof_from_reference_pie(reference, n, log_blowup):
    ref_pie, ref_settings = reference[(n, log_blowup)][:2]
    pie = pie_from_arrays(
        {k: (t.log_size, t.columns) for k, t in ref_pie.trace_tables.items()},
        ref_pie.metadata.execution_resources.op_counter,
    )
    settings = settings_from_dict(ref_settings.to_dict())
    return T.prove(pie, settings, _config(T, log_blowup), device="cpu")


@pytest.mark.parametrize("n,log_blowup", CASES)
def test_reference_verifier_accepts_port_proof(reference, n, log_blowup):
    proof = _port_proof_from_reference_pie(reference, n, log_blowup)
    assert serde.proof_to_flat_bytes(proof) == reference[(n, log_blowup)][3]
    ref_proof = ref_serde.proof_from_payload(_payload(proof))
    assert ref_verify(ref_proof, reference[(n, log_blowup)][1])


@pytest.mark.parametrize("where", ["sampled_value", "queried_value", "fri_root"])
def test_tampered_port_proof_is_rejected(reference, where):
    proof = _port_proof_from_reference_pie(reference, 8, 1)
    payload = copy.deepcopy(_payload(proof))
    pcs = payload["pcs"]
    if where == "sampled_value":
        target = pcs["sampled_values"][1][3][0]
    elif where == "queried_value":
        target = pcs["tree_queried_values"][1][0]
    else:
        target = pcs["fri"]["layer_roots"][0]
    target.view(np.uint8)[1] ^= 0x01  # one byte
    with pytest.raises(RefLuminairError):
        ref_verify(ref_serde.proof_from_payload(payload), reference[(8, 1)][1])


def test_prove_rejects_bad_blowup(reference):
    ref_pie, ref_settings = reference[(8, 1)][:2]
    pie = pie_from_arrays({k: (t.log_size, t.columns) for k, t in ref_pie.trace_tables.items()})
    bad = T.PcsConfig(fri=T.FriConfig())
    bad.fri.log_blowup_factor = 5
    with pytest.raises(ProverError):
        T.prove(pie, settings_from_dict(ref_settings.to_dict()), bad, device="cpu")
