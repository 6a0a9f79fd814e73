"""The granite_h_micro cell at a CPU size (hidden 16, a Mamba and an
attention layer, cache 8): a traced run through the harness is correct
and reports h2d_repeat_mb; the reader of the counter gives None where the
program counts nothing under its name."""

import json
import math
import shutil
import time
from types import SimpleNamespace

import pytest

from conftest import ROOT, SEED

CELL = "granite_h_micro.pcs20"
SMALL = dict(hidden_size=16, head_dim=8, num_attention_heads=1, num_key_value_heads=1, mamba_n_heads=2,
             mamba_d_head=4, mamba_d_state=4, mamba_expand=1, mlp_columns=8, cached_positions=8,
             num_hidden_layers=2, layer_types=["mamba", "attention"])


def small_root(root):
    """A checkout root whose granite_h_micro configuration is SMALL."""
    from luminair_tpu_torch.models import granite_hybrid

    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    cfg = json.loads((ROOT / "portbench" / "configs" / "granite_h_micro.json").read_text())
    cfg.update(SMALL)
    cfg["layers"] = [list(s) for s in granite_hybrid.parameter_shapes(cfg)]
    shapes = granite_hybrid.Sizes.of(cfg).input_shapes()
    for name, spec in cfg["inputs"].items():
        spec["shape"] = list(shapes[name])
    cfg["inputs"]["norm_ssq_rest"]["columns"] = [["uniform", 5.0, 15.0]]
    (root / "portbench" / "configs").mkdir(parents=True)
    (root / "portbench" / "configs" / "granite_h_micro.json").write_text(json.dumps(cfg))
    return root


def test_a_traced_cpu_run_is_correct_and_counts_repeated_inputs(tmp_path):
    from luminair_tpu_torch.models import granite_hybrid

    from portbench import harness, loader

    root = small_root(tmp_path)
    r = harness.run(root, CELL, SEED, 0.5, True, "cpu", time.perf_counter())
    assert r["correct"], r["checks"]
    cfg = loader.cell(root, CELL).config
    sizes = granite_hybrid.Sizes.of(cfg)
    # every w, and each Mamba layer's two biases (conv, dt_bias), set once; the inputs set each request
    weights = sum(i * o for i, o in cfg["layers"]) + sizes.count("mamba") * (sizes.xbc_channels + sizes.mamba_heads)
    inputs = sum(math.prod(s) for s in sizes.input_shapes().values())
    # the settings pass stages the weights again, the trace pass the weights and the inputs
    assert r["metrics"]["h2d_repeat_mb"]["value"] == pytest.approx(8 * (2 * weights + inputs) / 1e6)


def _request(i, repeat):
    from luminair_tpu_torch import tracing

    counts = {} if repeat is None else {tracing.H2D_REPEAT: repeat}
    return tracing.Request(i, [tracing.Span("settings", "", 0, 1, counts=counts),
                               tracing.Span("prove", "", 0, 1)])


@pytest.mark.parametrize("repeats,want", [((2_000_000, 4_000_000), 3.0), ((0, 0), 0.0), ((None, None), None),
                                          ((5, None), None)])
def test_the_reader_gives_the_mean_and_none_without_the_counter(monkeypatch, repeats, want):
    from luminair_tpu_torch import tracing

    from portbench import loader

    monkeypatch.setattr(tracing, "requests", lambda: [_request(i, x) for i, x in enumerate(repeats)])
    got = loader.reader("h2d_repeat_mb").read(SimpleNamespace(done=[object()] * 2, profile=None))
    assert got == (None if want is None else pytest.approx(want))
