"""A run's result line, the import check and the refusals without a card
or without the program."""

import json
import math
import os
import shutil
import subprocess
import sys
import time

import pytest

from conftest import ROOT, SEED


def _run(tiny, cell, trace=False, seconds=1.0):
    from portbench import harness

    return harness.run(tiny, cell, SEED, seconds, trace, "cpu", time.perf_counter())


def test_the_result_line_has_its_shape(tiny):
    r = _run(tiny, "mul_add.pcs20")
    assert list(r) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert r["correct"] is True and r["attempted"] >= 1 and r["failed"] == 0
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    e2e = {m["name"] for m in bench["end_to_end"] if "mul_add.pcs20" in m.get("workloads", ["mul_add.pcs20"])}
    assert set(r["metrics"]) == e2e == {"proved_cells_per_s", "setup_s"}
    assert r["metrics"]["proved_cells_per_s"]["unit"] == "cells/s" and r["metrics"]["setup_s"]["value"] > 0
    assert set(r["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(r["checks"]) == {"requests_failed", "outputs_off", "settings_off", "header_off", "proofs_rejected"}
    assert all(c == {"value": 0, "limit": 0} for c in r["checks"].values())
    json.dumps(r, allow_nan=False)


def test_a_traced_run_reports_the_per_layer_seconds(tiny):
    assert set(_run(tiny, "bs_pinn.pcs20", seconds=0.5)["metrics"]) == {"proved_cells_per_s", "proof_p90_s",
                                                                         "setup_s"}
    r = _run(tiny, "bs_pinn.pcs20", trace=True, seconds=0.5)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    seconds = {m["name"] for m in bench["per_layer"] if m["unit"] == "s"}
    assert r["correct"] and set(r["metrics"]) == seconds  # rooflines and the idle share need the card
    assert all(v["value"] > 0 for v in r["metrics"].values())
    assert list(r)[-1] == "checks"


def test_the_90th_percentile_by_nearest_rank():
    from portbench.harness import nearest_rank

    assert nearest_rank(list(range(1, 101)), 0.9) == 90
    assert nearest_rank([3.0, 1.0, 2.0], 0.9) == 3.0 and nearest_rank([5.0], 0.9) == 5.0


def test_the_import_check_compares_whole_top_level_names(monkeypatch):
    from portbench import harness

    import luminair_tpu_torch  # noqa: F401  (its name begins with the JAX package's)

    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "luminair_tpu.fields", object())
    monkeypatch.setitem(sys.modules, "jaxlib", object())
    assert harness.forbidden_modules() == ["jaxlib", "luminair_tpu"]


def test_a_run_loads_neither_jax_nor_the_jax_package(tiny):
    code = ("import sys, time; from pathlib import Path\n"
            f"sys.path.insert(0, {str(ROOT)!r})\n"
            "from portbench import harness\n"
            f"harness.run(Path({str(tiny)!r}), 'bs_pinn.pcs20', {SEED}, 0.2, False, 'cpu', time.perf_counter())\n"
            "print(harness.forbidden_modules(), sorted(m for m in sys.modules if m.startswith('luminair')))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600,
                         env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert out.returncode == 0, out.stderr[-2000:]
    bad, loaded = out.stdout.strip().splitlines()[-1].split("] ", 1)
    assert bad == "[" and "luminair_tpu_torch" in loaded and "'luminair_tpu'" not in loaded


def _cli(cwd, *args):
    return subprocess.run([sys.executable, "portbench/run.py", *args], cwd=cwd, capture_output=True, text=True,
                          timeout=300, env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})


def test_without_a_card_the_command_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = _cli(ROOT, "--workload", "bs_pinn.pcs20", "--seed", str(SEED), "--seconds", "1", "--trace", "0")
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "needs 1 CUDA device" in out.stderr


def test_a_checkout_of_the_benchmark_alone_prints_no_result(tmp_path):
    """BENCHMARK.json and portbench/ without the program: no result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    out = _cli(tmp_path, "--workload", "mul_add.pcs20", "--seed", "1", "--seconds", "1", "--trace", "0")
    assert out.returncode != 0 and out.stdout.strip() == ""
    code = ("import sys, time; from pathlib import Path\n"
            f"sys.path.insert(0, {str(tmp_path)!r})\n"
            "from portbench import harness\n"
            f"harness.run(Path({str(tmp_path)!r}), 'mul_add.pcs20', 1, 1.0, False, 'cpu', time.perf_counter())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300, cwd=tmp_path,
                         env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert out.returncode != 0 and "luminair_tpu_torch" in out.stderr and out.stdout.strip() == ""


@pytest.mark.parametrize("warm, done", [
    ([30.0], False),
    ([30.0, 0.5, 0.3, 0.21], False),
    ([30.0, 0.5, 0.21, 0.2, 0.22], True),
    ([30.0] + [0.1, 0.3] * 6, True),
])
def test_set_up_warms_until_the_requests_agree(warm, done):
    from portbench import harness

    assert harness.settled(warm) is done
