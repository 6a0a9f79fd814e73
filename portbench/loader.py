"""Finds a cell's parts by the names BENCHMARK.json gives them: its
configuration (the `file` of its `configs` entry, whose `model` names
portbench/models/<model>.py on the program's side and
portbench/reference/<model>.py, the plain reference), its mix
(portbench/traffic/<traffic>.json) and each per-layer metric's reader
(portbench/metrics/<name>.py).  Adding any of them adds files and
entries; no file here names one."""

from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Dict, List

HERE = Path(__file__).resolve().parent


@dataclass
class Cell:
    root: Path
    spec: dict  # the BENCHMARK.json entry of the cell
    config: dict
    mix: dict
    model: ModuleType  # builds the program's graph
    reference: ModuleType  # the plain reference
    end_to_end: List[dict]  # the cell's end-to-end metrics' entries
    per_layer: List[dict]  # the cell's per-layer metrics' entries
    readers: Dict[str, ModuleType]

    @property
    def name(self) -> str:
        return self.spec["name"]


def bench(root: Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _for_cell(entries: List[dict], cell: str) -> List[dict]:
    return [m for m in entries if "workloads" not in m or cell in m["workloads"]]


def reader(name: str) -> ModuleType:
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"{__package__}.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell(root: Path, name: str) -> Cell:
    b = bench(root)
    specs = {w["name"]: w for w in b["workloads"]}
    if name not in specs:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(specs)})")
    spec = specs[name]
    cfg_entry = next(c for c in b["configs"] if c["name"] == spec["config"])
    config = json.loads((root / cfg_entry["file"]).read_text())
    mix = json.loads((HERE / "traffic" / f"{spec['traffic']}.json").read_text())
    if (mix.get("loop"), mix.get("clients")) != ("closed", 1):
        raise ValueError(f"mix {spec['traffic']}: the harness drives one client in a closed loop, "
                         f"not loop {mix.get('loop')!r} with {mix.get('clients')!r} clients")
    per_layer = _for_cell(b["per_layer"], name)
    return Cell(
        root=root,
        spec=spec,
        config=config,
        mix=mix,
        model=importlib.import_module(f"{__package__}.models.{config['model']}"),
        reference=importlib.import_module(f"{__package__}.reference.{config['model']}"),
        end_to_end=_for_cell(b["end_to_end"], name),
        per_layer=per_layer,
        readers={m["name"]: reader(m["name"]) for m in per_layer},
    )
