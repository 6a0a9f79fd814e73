"""The black-scholes PINN through luminair_tpu_torch on the CPU, against the
reference package: a small network of the same shape (Linear + tanh, so
mul, sum_reduce, add, exp2 with its exp2_lookup table, recip), built from
the same weights in both packages.  The PIE columns and the flat proof bytes
must be equal, the reference verifier must accept the port's proof and
reject it with one sampled value changed."""

import copy

import numpy as np
import pytest

from examples import black_scholes_nn as ref_example
from luminair_tpu import prelude as R
from luminair_tpu import serde as ref_serde
from luminair_tpu.errors import LuminairError as RefLuminairError
from luminair_tpu.nn import Linear as RefLinear
from luminair_tpu.parallel import accel
from luminair_tpu.verifier import verify as ref_verify
from luminair_tpu_torch import fields as f
from luminair_tpu_torch import prelude as T
from luminair_tpu_torch import serde
from luminair_tpu_torch.models import black_scholes as bs

SIZES = ((2, 4), (4, 1))
XS = np.array([[0.5, 0.25], [-0.3, 0.1]])  # small inputs keep the exp2 table at 2^14 rows


def _small_weights():
    """The 2-4-1 network's weights, drawn as load_weights() draws the
    flagship's (seed 1234, scale 1/sqrt(fan_in), zero biases)."""
    rng = np.random.default_rng(1234)
    w = {}
    for i, (fan_in, fan_out) in enumerate(SIZES, start=1):
        w[f"w{i}"] = rng.normal(scale=1.0 / np.sqrt(fan_in), size=(fan_in, fan_out))
        w[f"b{i}"] = np.zeros(fan_out)
    return w


def _reference_graph(w):
    cx = R.Graph()
    l1 = RefLinear(2, 4, True, cx)
    l1.weight.set(w["w1"])
    l1.bias.set(w["b1"])
    l2 = RefLinear(4, 1, True, cx)
    l2.weight.set(w["w2"])
    l2.bias.set(w["b2"])
    x = cx.tensor(XS.shape)
    l2(l1(x).tanh()).retrieve()
    x.set(XS)
    cx.compile()
    return cx


@pytest.fixture(scope="module")
def pinn():
    """(reference pie, settings, proof bytes, port pie, settings, proof,
    port output) -- the reference on its host path."""
    w = _small_weights()
    was = accel.enabled()
    accel.enable(False)
    try:
        cx = _reference_graph(w)
        ref_settings = R.gen_circuit_settings(cx)
        ref_pie = R.gen_trace(cx, ref_settings)
        ref_bytes = ref_serde.proof_to_flat_bytes(R.prove(ref_pie, ref_settings))
    finally:
        accel.enable(was)
    cx = T.Graph()
    x, out = bs.build(cx, w, batch=XS.shape[0])
    x.set(XS)
    cx.compile()
    settings = T.gen_circuit_settings(cx, device="cpu")
    pie = T.gen_trace(cx, settings, device="cpu")
    proof = T.prove(pie, settings, device="cpu")
    return ref_pie, ref_settings, ref_bytes, pie, settings, proof, np.asarray(out.data()), w


def test_pie_matches_reference(pinn):
    ref_pie, ref_settings, _, pie, settings, *_ = pinn
    assert settings.to_dict() == ref_settings.to_dict()
    assert sorted(pie.trace_tables) == sorted(ref_pie.trace_tables)
    assert {"mul", "sum_reduce", "add", "exp2", "recip", "exp2_lookup"} <= set(pie.trace_tables)
    for name, t in pie.trace_tables.items():
        ref_t = ref_pie.trace_tables[name]
        assert t.log_size == ref_t.log_size and list(t.columns) == list(ref_t.columns)
        for col, v in t.columns.items():
            assert np.array_equal(f.tensor_to_u32(v), ref_t.columns[col]), (name, col)


def test_proof_bytes_match_reference(pinn):
    _, ref_settings, ref_bytes, _, settings, proof, *_ = pinn
    assert serde.proof_to_flat_bytes(proof) == ref_bytes
    assert serde.settings_to_flat_bytes(settings) == ref_serde.settings_to_flat_bytes(ref_settings)


def test_reference_verifier_accepts_and_rejects(pinn):
    _, ref_settings, _, _, _, proof, *_ = pinn
    payload = serde.proof_to_payload(proof)
    assert ref_verify(ref_serde.proof_from_payload(payload), ref_settings)
    bad = copy.deepcopy(payload)
    bad["pcs"]["sampled_values"][1][0][0].view(np.uint8)[1] ^= 0x01
    with pytest.raises(RefLuminairError):
        ref_verify(ref_serde.proof_from_payload(bad), ref_settings)


@pytest.fixture(scope="module")
def pinn_hs(pinn):
    """(reference flat bytes, port proof) of the 2-4-1 PINN at
    PcsConfig.high_security(), the reference on its host path."""
    ref_pie, ref_settings, _, pie, settings, *_ = pinn
    was = accel.enabled()
    accel.enable(False)
    try:
        ref_bytes = ref_serde.proof_to_flat_bytes(R.prove(ref_pie, ref_settings, R.PcsConfig.high_security()))
    finally:
        accel.enable(was)
    return ref_bytes, T.prove(pie, settings, T.PcsConfig.high_security(), device="cpu")


def test_high_security_proof_bytes_match_reference(pinn_hs):
    ref_bytes, proof = pinn_hs
    assert serde.proof_to_flat_bytes(proof) == ref_bytes


def test_high_security_verifies_at_80_bits_and_binds_the_nonce(pinn, pinn_hs):
    """The reference verifier holds the proof to the 80-bit profile -- with
    the last FRI layer at 2^3, where both packages' prove() clamp it for
    this network's smallest committed column -- and rejects it with the
    PoW nonce plus one."""
    ref_settings = pinn[1]
    payload = serde.proof_to_payload(pinn_hs[1])
    profile = R.PcsConfig.high_security()
    profile.fri.log_last_layer_degree_bound = 3
    assert ref_verify(ref_serde.proof_from_payload(payload), ref_settings,
                      expected_config=profile, min_security_bits=80)
    bad = copy.deepcopy(payload)
    bad["pcs"]["pow_nonce"] += 1
    bad["pcs"]["fri"]["pow_nonce"] += 1
    with pytest.raises(RefLuminairError):
        ref_verify(ref_serde.proof_from_payload(bad), ref_settings)


def test_model_output_near_float_reference(pinn):
    out, w = pinn[6], pinn[7]
    assert np.max(np.abs(out - bs.reference_forward(w, XS))) < 0.05


def test_load_weights_matches_example():
    ref = ref_example.load_weights()
    port = bs.load_weights()
    assert sorted(ref) == sorted(port)
    for k in ref:
        assert np.array_equal(ref[k], port[k])
