"""CPU tests of the benchmark.  Run from the repository root:

    python -m pytest portbench/tests -q

Tests marked `cuda` run a cell on the card and skip without one.
"""

import copy
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

SEED = 2**31 + 12345  # past 32 signed bits, as the driver's seeds are


def tiny_bench(root: Path) -> Path:
    """A checkout root whose BENCHMARK.json runs the benchmark's cells at
    CPU sizes: the 2-4-4-1 PINN at batch 2 (inputs drawn narrow, so its
    exp2 table stays small) and a*b + a at N = 4."""
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    pinn = json.loads((ROOT / "portbench" / "configs" / "bs_pinn.json").read_text())
    pinn.update(layers=[[2, 4], [4, 4], [4, 1]], batch=2)
    pinn["inputs"]["x"] = {"shape": [2, 2], "columns": [["uniform", 0.1, 0.2], ["uniform", 0.05, 0.1]]}
    ma = json.loads((ROOT / "portbench" / "configs" / "mul_add.json").read_text())
    ma["n"] = 4
    for k in ("a", "b"):
        ma["inputs"][k]["shape"] = [4, 4]
    (root / "cfg").mkdir(parents=True, exist_ok=True)
    for cfg in (pinn, ma):
        (root / "cfg" / f"{cfg['name']}.json").write_text(json.dumps(cfg))
    for c in b["configs"]:
        c["file"] = f"cfg/{c['name']}.json"
    for config in ("bs_pinn", "mul_add"):
        b["workloads"].append({"name": f"{config}.pcs80_b2", "config": config, "traffic": "pcs80_b2", "chips": 1,
                               "why": "the tiny graph at blowup 4"})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    return root


@pytest.fixture(scope="session")
def tiny(tmp_path_factory) -> Path:
    return tiny_bench(tmp_path_factory.mktemp("tiny"))


@pytest.fixture(scope="session")
def verifier():
    from portbench.reference.verifier import Verifier

    return Verifier()
