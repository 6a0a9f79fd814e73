"""The generator: the same seed gives the same requests."""

import json

import numpy as np
import pytest

from conftest import ROOT, SEED


def _cfg(name):
    return json.loads((ROOT / "portbench" / "configs" / f"{name}.json").read_text())


@pytest.mark.parametrize("config", ["bs_pinn", "mul_add"])
def test_the_same_seed_gives_the_same_weights_and_requests(config):
    from portbench import traffic

    cfg = _cfg(config)
    a, b = traffic.Draws(SEED, "cpu"), traffic.Draws(SEED, "cpu")
    wa, wb = a.weights(cfg), b.weights(cfg)
    assert wa.keys() == wb.keys() and all(np.array_equal(wa[k], wb[k]) for k in wa)
    for stream in ((1, 0), (1, 7), (2, 0)):
        xa, xb = a.inputs(cfg, *stream), b.inputs(cfg, *stream)
        assert all(np.array_equal(xa[k], xb[k]) for k in xa)
        assert all(xa[k].shape == tuple(cfg["inputs"][k]["shape"]) and xa[k].dtype == np.float64 for k in xa)
    other = traffic.Draws(SEED + 1, "cpu").inputs(cfg, 1, 0)
    first, second = a.inputs(cfg, 1, 0), a.inputs(cfg, 1, 1)
    assert all(not np.array_equal(first[k], other[k]) and not np.array_equal(first[k], second[k]) for k in first)


def test_inputs_follow_their_rules():
    from portbench import traffic

    cfg = _cfg("bs_pinn")
    x = traffic.Draws(2**40 + 3, "cpu").inputs(cfg, 1, 5)["x"]
    assert 5.0 <= x[:, 0].min() and x[:, 0].max() <= 30.0 and 0.05 <= x[:, 1].min() and x[:, 1].max() <= 1.0
    w = traffic.Draws(SEED, "cpu").weights(cfg)
    assert sorted(w) == ["b1", "b2", "b3", "w1", "w2", "w3"] and not any(w[b].any() for b in ("b1", "b2", "b3"))
    assert abs(w["w2"].std() * np.sqrt(64) - 1.0) < 0.1
    m = traffic.Draws(SEED, "cpu").inputs(_cfg("mul_add"), 1, 0)
    assert abs(m["a"].mean()) < 0.01 and abs(m["b"].std() - 1.0) < 0.01


def test_a_mix_states_its_profile():
    from portbench import traffic

    bits = {}
    for name in ("pcs20", "pcs80_b2"):
        mix = json.loads((ROOT / "portbench" / "traffic" / f"{name}.json").read_text())
        bits[name] = traffic.pcs(mix).security_bits
        assert mix["loop"] == "closed" and mix["clients"] == 1
    assert bits == {"pcs20": 20, "pcs80_b2": 80}
