"""The plain reference at small sizes: the program's outputs, settings and
tables are the reference's; its proofs pass the frozen verifier, which
refuses them against other settings."""

import json

import numpy as np
import pytest

from conftest import ROOT, SEED


def _program(cx, device="cpu"):
    from luminair_tpu_torch import prelude as T

    s = T.gen_circuit_settings(cx, device=device)
    return s, T.gen_trace(cx, s, device=device)


def _pinn_cfg(**kw):
    cfg = json.loads((ROOT / "portbench" / "configs" / "bs_pinn.json").read_text())
    cfg.update(kw)
    return cfg


@pytest.mark.parametrize("layers,batch,spot", [
    ([[2, 4], [4, 4], [4, 1]], 3, (0.1, 0.2)),
    ([[2, 64], [64, 64], [64, 1]], 2, (5.0, 30.0)),  # the configuration's widths and inputs
])
def test_pinn_outputs_settings_and_tables_are_the_references(layers, batch, spot):
    from luminair_tpu_torch import serde
    from portbench import checks, traffic
    from portbench.models import bs_pinn as model
    from portbench.reference import bs_pinn as ref, settings as ref_settings

    cfg = _pinn_cfg(layers=layers, batch=batch)
    cfg["inputs"]["x"] = {"shape": [batch, 2], "columns": [["uniform", *spot], ["uniform", 0.05, 1.0]]}
    draws = traffic.Draws(SEED, "cpu")
    w, x = draws.weights(cfg), draws.inputs(cfg, 1, 0)
    cx, tensors, out = model.build(cfg, w)
    tensors["x"].set(x["x"])
    s, pie = _program(cx)
    raw, tape = ref.forward(cfg, w, x)
    assert np.array_equal(out.data().reshape(-1), (raw / 4096.0).reshape(-1))
    assert serde.settings_to_flat_bytes(s) == ref_settings.flat_bytes(tape)
    st = checks.statement_of(tape)
    assert {k: t.n_rows for k, t in pie.trace_tables.items()} == st.rows
    low, low_tape = ref.forward_float32(cfg, w, x)
    assert not np.array_equal(low, raw) and ref_settings.flat_bytes(low_tape) != ref_settings.flat_bytes(tape)


def test_mul_add_outputs_settings_and_tables_are_the_references():
    from luminair_tpu_torch import serde
    from portbench import checks
    from portbench.models import mul_add as model
    from portbench.reference import mul_add as ref, settings as ref_settings

    rng = np.random.default_rng(SEED)
    x = {"a": rng.normal(size=(8, 8)), "b": rng.normal(size=(8, 8))}
    cx, tensors, out = model.build({"n": 8}, {})
    for k, v in x.items():
        tensors[k].set(v)
    s, pie = _program(cx)
    raw, tape = ref.forward({"n": 8}, {}, x)
    assert np.array_equal(out.data(), raw / 4096.0)
    assert serde.settings_to_flat_bytes(s) == ref_settings.flat_bytes(tape)
    assert {k: t.n_rows for k, t in pie.trace_tables.items()} == checks.statement_of(tape).rows


def test_fixed_point_rounds_as_the_statement_says():
    from portbench.reference import fixed as fx

    assert fx.mul(np.int64(-1), np.int64(1)) == 0 and fx.mul(np.int64(-4097), np.int64(4096)) == -4097
    assert fx.mul(np.int64(-6144), np.int64(2048)) == -3072 and fx.mul(np.int64(6143), np.int64(1)) == 1
    assert fx.recip(np.array([3, -3, 0])).tolist() == [5592405, -5592405, 0]
    assert fx.from_float(np.array([0.5 / 4096, 1.5 / 4096, -0.5 / 4096])).tolist() == [0, 2, 0]
    assert fx.coalesce([(5, 9), (0, 3), (4, 4), (20, 30)]) == [(0, 9), (20, 30)]
    assert fx.lut_range(np.array([-4096, 4096])) == (-4915, 4915)


def test_a_proof_head_is_read_and_junk_is_refused():
    from portbench.reference import proof

    with pytest.raises(ValueError):
        proof.header(b"LMSF" + bytes(60))


def test_the_frozen_verifier_judges_a_proof_against_the_references_settings(verifier):
    from luminair_tpu_torch import prelude as T, serde
    from portbench import checks
    from portbench.models import bs_pinn as model
    from portbench.reference import bs_pinn as ref, proof, settings as ref_settings
    from portbench import traffic

    cfg = _pinn_cfg(layers=[[2, 4], [4, 1]], batch=2)
    cfg["inputs"]["x"] = {"shape": [2, 2], "columns": [["uniform", 0.1, 0.2], ["uniform", 0.05, 0.1]]}
    draws = traffic.Draws(SEED, "cpu")
    w, x = draws.weights(cfg), draws.inputs(cfg, 1, 0)
    cx, tensors, _ = model.build(cfg, w)
    tensors["x"].set(x["x"])
    s, pie = _program(cx)
    data = serde.proof_to_flat_bytes(T.prove(pie, s, device="cpu"))
    _, tape = ref.forward(cfg, w, x)
    flat = ref_settings.flat_bytes(tape)
    config, claim = proof.header(data)
    assert config["n_queries"] == 15 and claim
    assert verifier.verify(data, flat, 20) == (0, "ok")
    assert verifier.verify(data, flat, 21)[0] == 10  # below the bits asked for
    tape.lut_sources["exp2"][0] = tape.lut_sources["exp2"][0] + 1  # another range, another table
    assert verifier.verify(data, ref_settings.flat_bytes(tape), 20)[0] != 0
    bad = bytearray(data)
    bad[-100] ^= 1
    assert verifier.verify(bytes(bad), flat, 20)[0] != 0
    assert checks.statement_of(ref.forward(cfg, w, x)[1]).claim
