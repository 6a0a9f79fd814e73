"""End to end: the a*b + a bench graph through luminair_tpu_torch on the CPU,
byte for byte against the reference package's host proof, accepted by the
reference verifier and by the port's."""

import copy

import numpy as np
import pytest
import torch

from luminair_tpu import prelude as R
from luminair_tpu import serde as ref_serde
from luminair_tpu.errors import LuminairError as RefLuminairError
from luminair_tpu.parallel import accel
from luminair_tpu.verifier import verify as ref_verify
from luminair_tpu_torch import fields as f
from luminair_tpu_torch import prelude as T
from luminair_tpu_torch import serde
from luminair_tpu_torch.air.pie import pie_from_arrays
from luminair_tpu_torch.air.settings import settings_from_dict
from luminair_tpu_torch.errors import ProverError
from luminair_tpu_torch.graph.trace import gen_circuit_settings_host, gen_trace_host

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
    """The host interpreter and the device interpreter (on CPU tensors)."""
    ref_pie, ref_settings = reference[(n, 1)][:2]
    for settings_fn, trace_fn in (
        (gen_circuit_settings_host, gen_trace_host),
        (lambda cx: T.gen_circuit_settings(cx, device="cpu"), lambda cx, s: T.gen_trace(cx, s, device="cpu")),
    ):
        cx = _graph(T, n)
        settings = settings_fn(cx)
        pie = trace_fn(cx, settings)
        assert settings.to_dict() == ref_settings.to_dict()
        assert sorted(pie.trace_tables) == sorted(ref_pie.trace_tables)
        for name, t in pie.trace_tables.items():
            ref_t = ref_pie.trace_tables[name]
            assert t.log_size == ref_t.log_size
            assert list(t.columns) == list(ref_t.columns)
            for col, v in t.columns.items():
                words = f.tensor_to_u32(v) if isinstance(v, torch.Tensor) else v
                assert np.array_equal(words, ref_t.columns[col]), (name, col)


@pytest.mark.parametrize("n,log_blowup", CASES)
def test_proof_bytes_match_reference(reference, n, log_blowup):
    ref_bytes = reference[(n, log_blowup)][3]
    cx = _graph(T, n)
    settings = T.gen_circuit_settings(cx, device="cpu")
    proof = T.prove(T.gen_trace(cx, settings, device="cpu"), settings, _config(T, log_blowup), device="cpu")
    assert serde.proof_to_flat_bytes(proof) == ref_bytes
    assert serde.settings_to_flat_bytes(settings) == ref_serde.settings_to_flat_bytes(reference[(n, 1)][1])


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
    """The port's proof, accepted by the reference verifier (through the
    payload) and by the port's."""
    proof = _port_proof_from_reference_pie(reference, n, log_blowup)
    assert serde.proof_to_flat_bytes(proof) == reference[(n, log_blowup)][3]
    ref_proof = ref_serde.proof_from_payload(serde.proof_to_payload(proof))
    assert ref_verify(ref_proof, reference[(n, log_blowup)][1])
    assert T.verify(proof, settings_from_dict(reference[(n, log_blowup)][1].to_dict()), device="cpu")


@pytest.mark.parametrize("where", ["sampled_value", "queried_value", "fri_root"])
def test_tampered_port_proof_is_rejected(reference, where):
    proof = _port_proof_from_reference_pie(reference, 8, 1)
    payload = copy.deepcopy(serde.proof_to_payload(proof))
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
    with pytest.raises(T.StwoVerifierError):
        T.verify(serde.proof_from_payload(payload), settings_from_dict(reference[(8, 1)][1].to_dict()), device="cpu")


HS_BLOWUPS = [1, 2]


@pytest.fixture(scope="module")
def reference_hs(reference):
    """{log_blowup: ref flat bytes} of the N=8 graph at
    PcsConfig.high_security(log_blowup), on the reference's host path."""
    was = accel.enabled()
    accel.enable(False)
    try:
        pie, settings = reference[(8, 1)][:2]
        return {b: ref_serde.proof_to_flat_bytes(R.prove(pie, settings, R.PcsConfig.high_security(b)))
                for b in HS_BLOWUPS}
    finally:
        accel.enable(was)


@pytest.mark.parametrize("log_blowup", HS_BLOWUPS)
def test_high_security_proof_matches_reference_and_verifies(reference, reference_hs, log_blowup):
    """At the 80-bit profile (16 PoW bits, 64 / 32 queries): the port's
    proof (device interpreter and prover on CPU tensors) has the reference's
    bytes; the reference verifier accepts it holding it to the profile and
    to 80 bits, and rejects it with the PoW nonce plus one."""
    cx = _graph(T, 8)
    settings = T.gen_circuit_settings(cx, device="cpu")
    proof = T.prove(T.gen_trace(cx, settings, device="cpu"), settings, T.PcsConfig.high_security(log_blowup),
                    device="cpu")
    assert serde.proof_to_flat_bytes(proof) == reference_hs[log_blowup]
    ref_settings = reference[(8, 1)][1]
    payload = serde.proof_to_payload(proof)
    assert ref_verify(ref_serde.proof_from_payload(payload), ref_settings,
                      expected_config=R.PcsConfig.high_security(log_blowup), min_security_bits=80)
    bad = copy.deepcopy(payload)
    bad["pcs"]["pow_nonce"] += 1
    bad["pcs"]["fri"]["pow_nonce"] += 1
    with pytest.raises(RefLuminairError):
        ref_verify(ref_serde.proof_from_payload(bad), ref_settings)


def test_prove_rejects_bad_blowup(reference):
    ref_pie, ref_settings = reference[(8, 1)][:2]
    pie = pie_from_arrays({k: (t.log_size, t.columns) for k, t in ref_pie.trace_tables.items()})
    bad = T.PcsConfig(fri=T.FriConfig())
    bad.fri.log_blowup_factor = 5
    with pytest.raises(ProverError):
        T.prove(pie, settings_from_dict(ref_settings.to_dict()), bad, device="cpu")
