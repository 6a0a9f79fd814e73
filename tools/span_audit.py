#!/usr/bin/env python3
"""Audits the port's spans and copy counters against the device trace, on
a benchmark cell's requests (portbench's configurations and traffic).

    python3 tools/span_audit.py --workload bs_pinn.pcs20 --seed 3 [--requests 2] [--out FILE]

from the repository root, on a CUDA card.  After a few warm requests it

- counts the device synchronises a request's spans make
  (`tracing.device_sync`), with no listener and with `tracing.enable()`,
  and how many spans of the request would have synchronised had every
  span below a root ended with one (spans new to the tree listed in
  NEW_SPANS left out);
- profiles --requests requests (torch.profiler, CPU and CUDA, tracing on,
  as the benchmark's profiled window listens), and sets the bytes of the
  profiler's host-to-device copies (pageable and pinned) and
  device-to-host copies beside the program's counters of the same
  requests, in all and by the innermost `lum.*` range (span path) whose
  call made the copy;
- splits the device's idle time in that window by the innermost `lum.*`
  or `portbench.*` range open at each gap's middle.

Prints one JSON line (also written to --out).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

# Spans that the tree added below the passes' phases; a request's spans less
# these synchronised, one each, before spans listened.
NEW_SPANS = {
    "prove/phase0_preprocessed/build", "prove/phase0_preprocessed/upload", "prove/phase0_preprocessed/commit",
    "prove/phase1_main/columns", "prove/phase1_main/commit", "settings/flags/download",
    "settings/flags/settings_from_ranges", "prove/self_check/replay", "prove/self_check/oods_composition",
}
WARM = 3
TOP = 16


def _innermost(ranges, t):
    """The shortest range of `ranges` ((start, end, name), sorted by start)
    that holds t."""
    best = None
    for a, b, name in ranges:
        if a > t:
            break
        if a <= t <= b and (best is None or b - a < best[0]):
            best = (b - a, name)
    return best[1] if best else "outside any range"


def _kind(name: str) -> str:
    """A device copy record's kind as the program's counters name it."""
    if name.startswith("Memcpy HtoD"):
        return "h2d_pinned" if "Pinned" in name else "h2d_pageable" if "Pageable" in name else name
    return "d2h" if name.startswith("Memcpy DtoH") else name


def _add(d, k, v):
    d[k] = d.get(k, 0) + v


def trace_records(path: str):
    """From a chrome trace: the host's ranges, the device's intervals and
    each copy's (kind, bytes, host time of its call)."""
    events = json.loads(Path(path).read_text())["traceEvents"]
    calls = {}
    ranges, busy, copies = [], [], []
    for e in events:
        cat, args = e.get("cat", ""), e.get("args", {})
        if (cat == "cpu_op" and e["name"].startswith("lum.")) or (
                cat == "user_annotation" and e["name"].startswith("portbench.")):
            ranges.append((e["ts"], e["ts"] + e["dur"], e["name"]))
        elif cat == "cuda_runtime" and "correlation" in args:
            calls[args["correlation"]] = e["ts"]
    for e in events:
        cat, args = e.get("cat", ""), e.get("args", {})
        if cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            busy.append((e["ts"], e["ts"] + e["dur"]))
        if cat == "gpu_memcpy":
            copies.append((_kind(e["name"]), int(args.get("bytes", 0)), calls.get(args.get("correlation"))))
    ranges.sort()
    return ranges, sorted(busy), copies


def audit(workload: str, seed: int, n: int, dev) -> dict:
    import torch

    from luminair_tpu_torch import tracing
    from portbench import harness, loader, traffic
    from portbench.profile import WARM_UP_CYCLES, WARM_UP_LAUNCHES

    cell = loader.cell(ROOT, workload)
    draws = traffic.Draws(seed, dev)
    weights = draws.weights(cell.config)
    prover = harness.Prover(cell, weights, traffic.pcs(cell.mix), dev, sync=False)
    for j in range(WARM):
        prover.request(draws.inputs(cell.config, 2, j))

    # Synchronises a request.
    syncs = []
    real_sync = tracing.device_sync

    def counted(d):
        fn = real_sync(d)
        return None if fn is None else (lambda: (syncs.append(1), fn()))

    tracing.device_sync = counted
    try:
        prover.request(draws.inputs(cell.config, 2, WARM))
        quiet = len(syncs)
        syncs.clear()
        with tracing.enable():
            prover.request(draws.inputs(cell.config, 2, WARM + 1))
        listened = len(syncs)
    finally:
        tracing.device_sync = real_sync
    req = tracing.requests()[-1]
    every = [s for s in req.spans if s.parent and s.path not in NEW_SPANS]

    # The profiled window.
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with tracing.enable(), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(WARM_UP_LAUNCHES):
            torch.cuda._sleep(WARM_UP_CYCLES)
        torch.cuda.synchronize()
        time.sleep(0.01)
        t0 = time.perf_counter()
        for j in range(n):
            prover.request(draws.inputs(cell.config, 3, j))
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
        time.sleep(0.01)
    reqs = [q for q in tracing.requests() if q.complete][-n:]
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        ranges, busy, copies = trace_records(path)
    finally:
        os.unlink(path)
    lum = [r for r in ranges if r[2].startswith("lum.")]
    w0 = min(a for a, _, name in ranges if name.startswith("portbench."))
    w1 = max(b for _, b, name in ranges if name.startswith("portbench."))

    profiled, by_path_prof = {}, {}
    for kind, nbytes, at in copies:
        if at is None or not (w0 <= at <= w1):
            continue
        _add(profiled, kind, nbytes)
        _add(by_path_prof.setdefault(_innermost(lum, at).replace("lum.", "", 1), {}), kind, nbytes)
    counted_bytes, by_path_count = {}, {}
    for q in reqs:
        for s in q.spans:
            for k in ("h2d_pageable", "h2d_pinned", "d2h"):
                if s.counts.get(k):
                    _add(counted_bytes, k, s.counts[k])
                    _add(by_path_count.setdefault(s.path, {}), k, s.counts[k])
    paths = sorted(set(by_path_prof) | set(by_path_count),
                   key=lambda p: -sum(by_path_prof.get(p, {}).values()) - sum(by_path_count.get(p, {}).values()))
    by_path = {p: {"profiler": by_path_prof.get(p, {}), "counted": by_path_count.get(p, {})} for p in paths}

    merged = []
    for a, b in busy:
        if b < w0 or a > w1:
            continue
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([max(a, w0), min(b, w1)])
    gaps = {}
    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            _add(gaps, _innermost(ranges, (a + b) / 2), (b - a) / 1e6)
    busy_s = sum(b - a for a, b in merged) / 1e6
    return {
        "workload": workload, "seed": seed, "requests": n,
        "card": torch.cuda.get_device_name(dev),
        "syncs_a_request": {"no_listener": quiet, "enable": listened,
                            "spans_below_roots": sum(1 for s in req.spans if s.parent), "before_tree": len(every)},
        "spans_a_request": len(req.spans),
        "copies_bytes": {"profiler": profiled, "counted": counted_bytes},
        "copies_by_span": by_path,
        "counters_a_request": [{k: v for k, v in q.counters().items() if not k.startswith("launches.")}
                               for q in reqs],
        "launches_a_request": [{k[len("launches."):]: v for k, v in q.counters().items()
                                if k.startswith("launches.") and "@" not in k} for q in reqs],
        "window_s": window_s, "busy_s": busy_s, "traced_window_s": (w1 - w0) / 1e6,
        "idle_by_span_s": dict(sorted(gaps.items(), key=lambda kv: -kv[1])[:TOP]),
        "spans_s": [{s.path: round(s.seconds, 6) for s in q.spans} for q in reqs[-1:]],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--requests", type=int, default=2)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("span_audit: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    line = json.dumps(audit(args.workload, args.seed, args.requests, dev))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
