"""BENCHMARK.json and the files it names: found by name, within the
benchmark's contract, and extended by new files and entries alone."""

import hashlib
import json
import re
import shutil
import subprocess
import sys

import pytest

from conftest import ROOT, SEED

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_loads_by_name(name):
    from portbench import loader

    cell = loader.cell(ROOT, name)
    assert cell.config["name"] == cell.spec["config"]
    assert cell.mix["name"] == cell.spec["traffic"]
    assert hasattr(cell.model, "build") and hasattr(cell.reference, "forward")
    assert set(cell.readers) == {m["name"] for m in cell.per_layer}
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    assert all(m["moves"] in e2e for m in cell.per_layer)


@pytest.mark.parametrize("entry", BENCH["per_layer"], ids=lambda m: m["name"])
def test_reader_states_what_the_benchmark_says(entry):
    from portbench import loader

    r = loader.reader(entry["name"])
    assert (r.LAYER, r.UNIT, r.SOURCE, r.MOVES, r.BETTER) == (
        entry["layer"], entry["unit"], entry["source"], entry["moves"], entry["better"])


def test_benchmark_json_keeps_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"] and BENCH["command"][1].startswith("portbench/")
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert c["name"] in used and c["file"].startswith("portbench/")
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"] and cfg["source"] == c["source"]
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and 1 <= len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(CELLS) // 4)
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and "\n" not in m["layer"] and len(m["layer"]) <= 200
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))


def _digests(root):
    return {p: hashlib.sha256(p.read_bytes()).hexdigest() for p in sorted(root.rglob("*")) if p.is_file()}


def test_a_config_mix_cell_and_metric_are_added_by_files_and_entries_alone(tmp_path, tiny):
    """A copy of the benchmark gains a configuration (with its program-side
    builder and its reference), a mix, a cell and a per-layer metric by new
    files and entries; no file it had changes, and the new cell runs."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(tmp_path / "portbench")
    pb = tmp_path / "portbench"
    cfg = json.loads((tiny / "cfg" / "mul_add.json").read_text())
    cfg.update(name="dummy", model="dummy")
    (pb / "configs" / "dummy.json").write_text(json.dumps(cfg))
    (pb / "models" / "dummy.py").write_text((pb / "models" / "mul_add.py").read_text())
    (pb / "reference" / "dummy.py").write_text((pb / "reference" / "mul_add.py").read_text())
    mix = json.loads((pb / "traffic" / "pcs20.json").read_text())
    mix.update(name="dummy_mix")
    (pb / "traffic" / "dummy_mix.json").write_text(json.dumps(mix))
    (pb / "metrics" / "dummy_requests.py").write_text(
        'LAYER = "front end"\nUNIT = "requests"\nBETTER = "higher"\nSOURCE = "host_clock"\n'
        'MOVES = "proved_cells_per_s"\n\n\ndef read(r):\n    return float(len(r.done))\n')
    b = json.loads((tiny / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "dummy", "source": "https://example.org/dummy", "file": "portbench/configs/dummy.json",
                         "reduced": ["n"], "why": "a dummy"})
    b["workloads"].append({"name": "dummy.dummy_mix", "config": "dummy", "traffic": "dummy_mix", "chips": 1,
                           "why": "a dummy cell"})
    b["per_layer"].append({"name": "dummy_requests", "unit": "requests", "better": "higher", "source": "host_clock",
                           "layer": "front end", "moves": "proved_cells_per_s", "workloads": ["dummy.dummy_mix"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    code = (
        "import json, sys, time; from pathlib import Path\n"
        f"sys.path[:0] = [{str(tmp_path)!r}, {str(ROOT)!r}]\n"
        "from portbench import harness\n"
        f"r = harness.run(Path({str(tmp_path)!r}), 'dummy.dummy_mix', {SEED}, 0.5, True, 'cpu', time.perf_counter())\n"
        "print(json.dumps(r))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["metrics"]["dummy_requests"]["value"] >= 1
    assert _digests(pb).items() >= before.items()


@pytest.mark.parametrize("loop", [{"loop": "open"}, {"clients": 2}, {"loop": None}])
def test_a_mix_the_harness_does_not_drive_is_refused(tmp_path, tiny, loop):
    """The harness drives one client in a closed loop; a mix that states
    other traffic is refused rather than measured as one client."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copytree(tiny / "cfg", tmp_path / "cfg")
    shutil.copy(tiny / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    path = tmp_path / "portbench" / "traffic" / "pcs20.json"
    mix = json.loads(path.read_text())
    mix.update(loop)
    path.write_text(json.dumps({k: v for k, v in mix.items() if v is not None}))
    code = (f"import sys; sys.path.insert(0, {str(tmp_path)!r}); from pathlib import Path\n"
            "from portbench import loader\n"
            f"loader.cell(Path({str(tmp_path)!r}), 'mul_add.pcs20')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and "one client in a closed loop" in out.stderr
