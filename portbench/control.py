#!/usr/bin/env python3
"""The readings that set the check's limits: the program's, and its
controls', at the cell's own size, on several seeds in one process.

    python3 portbench/control.py --workload <cell> --seeds 11,12,13 [--requests 3] [--device cuda]

For each seed, `--requests` requests of the cell (the weights and inputs
of that seed, every request checked as a run checks its sample) give
three readings of the check's numbers, one JSON line a seed:

- program: the program as the cell runs it (the lower reading);
- float32: the reference's forward pass in float32, the precision below
  the statement's exact fixed point, put in place of the program's
  outputs and settings (outputs_off, settings_off; a graph without a
  lookup table has no settings to differ);
- fewer_queries: the program's own lower-security path, the mix's
  profile with one query fewer, below the bits the mix states (the
  proof's numbers: header_off, proofs_rejected).

A control that fails none of the numbers would leave its limit without an
upper reading.
"""

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def float32_readings(cell, weights: dict, done: list) -> dict:
    """The check's outputs_off and settings_off with the float32 forward
    pass in the program's place."""
    from portbench import checks
    from portbench.reference import fixed as fx, settings as ref_settings

    out = {"outputs_off": 0, "settings_off": 0}
    for d in done:
        exact, tape = cell.reference.forward(cell.config, weights, d.inputs)
        low, low_tape = cell.reference.forward_float32(cell.config, weights, d.inputs)
        out["outputs_off"] += checks.outputs_off(fx.to_float(low), exact)
        out["settings_off"] += checks.bytes_off(ref_settings.flat_bytes(low_tape), ref_settings.flat_bytes(tape))
    return out


def readings(root: Path, workload: str, seeds, n_requests: int, device: str) -> list:
    import torch

    from portbench import checks, harness, loader, traffic
    from portbench.reference.verifier import Verifier

    cell = loader.cell(root, workload)
    dev = torch.device(device)
    cfg = cell.config
    pcs = traffic.pcs(cell.mix)
    weaker = dataclasses.replace(pcs, n_queries=pcs.n_queries - 1)
    verifier = Verifier()
    out = []
    for seed in seeds:
        draws = traffic.Draws(seed, dev)
        weights = draws.weights(cfg)
        line = {"workload": workload, "seed": seed}
        for tag, profile in (("program", pcs), ("fewer_queries", weaker)):
            prover = harness.Prover(cell, weights, profile, dev, sync=False)
            done = []
            for i in range(n_requests):
                inputs = draws.inputs(cfg, 1, i)
                d = prover.request(inputs, i)
                d.inputs = inputs
                d.settings = prover.serde.settings_to_flat_bytes(d.settings)
                done.append(d)
            del prover
            numbers, _, _ = checks.judge(cell, weights, done, done, 0, pcs, None, verifier)
            line[tag] = numbers
            if tag == "program":
                line["float32"] = float32_readings(cell, weights, done)
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        out.append(line)
        print(json.dumps(line), flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--requests", type=int, default=3)
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from portbench.run import cache_dirs

    cache_dirs(ROOT)
    t = time.perf_counter()
    readings(ROOT, args.workload, [int(s) for s in args.seeds.split(",")], args.requests, args.device)
    print(f"control: {time.perf_counter() - t:.1f} s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
