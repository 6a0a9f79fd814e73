"""One run of one cell: set-up, the measured window, the traced window,
the checks, the result line.

A request hands fresh inputs to the compiled graph (`GraphTensor.set`),
then runs gen_circuit_settings -> gen_trace -> prove (self-check
included) on the device and writes the proof's flat bytes.  One client
takes its queue back to back: a closed loop.  The window runs requests
while fewer than --seconds have passed since it opened, and closes when
the last of them has returned; its length is that whole time.
"""

from __future__ import annotations

import gc
import math
import sys
import time
import traceback
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from . import checks, loader, traffic
from . import profile as prof
from . import work as work_mod
from .reference.verifier import Verifier

FORBIDDEN = ("jax", "jaxlib", "flax", "luminair_tpu")
PROGRAM_LOGGER = "luminair_tpu_torch"
PROVE_PHASES = ("phase0_preprocessed", "phase1_main", "phase2_interaction", "phase3a_composition",
                "phase3b_oods_fri", "self_check")
WARM_AGREE = 3  # set-up warms until this many requests after the first agree ...
WARM_SPREAD = 0.10  # ... each within this share of their median
WARM_MAX = 12  # warm requests at most
CHECKED_REQUESTS = 3  # requests the reference judges: drawn from the seed, and the slowest
PROFILED_REQUESTS = 2  # requests in the profiled window of a traced run


class Prover:
    """The system under test, driven the way a user drives it."""

    def __init__(self, cell: loader.Cell, weights: dict, pcs, device: torch.device, sync: bool):
        from luminair_tpu_torch import prelude, serde, tracing

        self.T, self.serde, self.tracing = prelude, serde, tracing
        self.graph, self.tensors, self.out = cell.model.build(cell.config, weights)
        self.config = prelude.PcsConfig(
            pow_bits=pcs.pow_bits,
            fri=prelude.FriConfig(log_blowup_factor=pcs.log_blowup, n_queries=pcs.n_queries,
                                  folds_per_layer=pcs.folds_per_layer,
                                  log_last_layer_degree_bound=pcs.log_last_layer_degree_bound))
        self.device = device
        self.sync = sync and device.type == "cuda"

    def _synced(self) -> float:
        if self.sync:
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def request(self, inputs: Dict[str, np.ndarray], index: int = -1) -> checks.Done:
        from torch.autograd.profiler import record_function

        T, dev = self.T, self.device
        t0 = time.perf_counter()
        with record_function("portbench.frontend"):
            for name, arr in inputs.items():
                self.tensors[name].set(arr)
        t1 = time.perf_counter()
        with record_function("portbench.settings"):
            settings = T.gen_circuit_settings(self.graph, device=dev)
            t2 = self._synced()
        with record_function("portbench.trace"):
            pie = T.gen_trace(self.graph, settings, device=dev)
            t3 = self._synced()
        with record_function("portbench.frontend"):
            outputs = self.out.data()
        t4 = time.perf_counter()
        with record_function("portbench.prove"):
            proof = T.prove(pie, settings, self.config, device=dev)
        del pie
        t5 = time.perf_counter()
        with record_function("portbench.frontend"):
            data = self.serde.proof_to_flat_bytes(proof)
        t6 = time.perf_counter()
        stages = {"frontend": (t1 - t0) + (t4 - t3) + (t6 - t5), "settings": t2 - t1, "trace": t3 - t2}
        phases = self.tracing.last_phases("prove")
        stages.update({k: phases.get(k, 0.0) for k in PROVE_PHASES})
        done = checks.Done(index, t6 - t0, stages, data, outputs)
        done.settings = settings
        return done


def settled(warm: List[float]) -> bool:
    """Whether set-up has warmed enough: the first request builds and
    loads, and the ones after it settle; warm until WARM_AGREE of those
    lie within WARM_SPREAD of their median, or WARM_MAX requests ran."""
    last = warm[1:][-WARM_AGREE:]
    if len(warm) >= WARM_MAX:
        return True
    if len(last) < WARM_AGREE:
        return False
    mid = sorted(last)[len(last) // 2]
    return all(abs(x - mid) <= WARM_SPREAD * mid for x in last)


def _stages(stages: Dict[str, float]) -> str:
    return ", ".join(f"{k} {v:.4f}" for k, v in stages.items())


def nearest_rank(values: List[float], q: float) -> float:
    """The q-quantile by nearest rank: the ceil(q n)-th smallest value."""
    s = sorted(values)
    return s[max(0, math.ceil(q * len(s)) - 1)]


class Readings:
    """What the per-layer readers read: the traced window's requests, the
    profiled window and the statement's work per request."""

    def __init__(self, done: List[checks.Done], profile: prof.Profile, work: dict):
        self.done = done
        self.profile = profile
        self.work = work

    def mean_stage(self, *names: str) -> float:
        return sum(sum(d.stages.get(n, 0.0) for n in names) for d in self.done) / len(self.done)


def run(root: Path, workload: str, seed: int, seconds: float, trace: bool, device: str,
        t_start: float, err=sys.stderr) -> dict:
    """One run; returns the result line's object (correct may be false).
    Raises where no result may be printed."""
    cell = loader.cell(root, workload)
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    cfg = cell.config
    pcs = traffic.pcs(cell.mix)
    marks = [("start", t_start), ("imports", time.perf_counter())]
    draws = traffic.Draws(seed, dev)
    weights = draws.weights(cfg)
    prover = Prover(cell, weights, pcs, dev, sync=trace)
    marks.append(("graph", time.perf_counter()))
    warm: List[float] = []
    while not settled(warm):
        j = len(warm)
        w = prover.request(draws.inputs(cfg, 2, j))
        warm.append(w.seconds)
        if j == 0:
            marks.append(("first request", time.perf_counter()))
            print("portbench: first request: " + _stages(w.stages), file=err)
    marks.append((f"{len(warm) - 1} warm requests", time.perf_counter()))
    print("portbench: warm request seconds " + " ".join(f"{x:.4f}" for x in warm), file=err)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t_start
    print("portbench: set-up " + ", ".join(f"{name} {b - a:.3f} s" for (_, a), (name, b) in zip(marks, marks[1:])),
          file=err)

    sample = checks.Sample(np.random.default_rng(traffic.stream_seed(seed, 4)), CHECKED_REQUESTS)
    done: List[checks.Done] = []
    failed = attempted = 0
    keep_outputs = True
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        i = attempted
        inputs = draws.inputs(cfg, 1, i)
        attempted += 1
        try:
            d = prover.request(inputs, i)
        except Exception:  # a request that fails counts as failed; the run goes on
            failed += 1
            traceback.print_exc(file=err)
            if failed >= 3 and not done:
                break
            continue
        keep_outputs = keep_outputs and d.outputs.nbytes <= checks.KEEP_OUTPUT_BYTES
        if sample.wants(d.seconds):
            d.inputs = inputs
            for old in sample.keep(d):
                old.strip(keep_outputs)
        else:
            d.strip(keep_outputs)
        done.append(d)
    window_s = time.perf_counter() - t0
    checked = sample.checked
    if done:
        secs = [d.seconds for d in done]
        mean = {k: sum(d.stages[k] for d in done) / len(done) for k in done[0].stages}
        print(f"portbench: request seconds min {min(secs):.4f} median {nearest_rank(secs, 0.5):.4f} "
              f"p90 {nearest_rank(secs, 0.9):.4f} max {max(secs):.4f}; mean stages: " + _stages(mean), file=err)
        fifths = [secs[len(secs) * k // 5 : len(secs) * (k + 1) // 5] for k in range(5)]
        print("portbench: mean request seconds by fifth of the window "
              + " ".join(f"{sum(f) / len(f):.4f}" for f in fifths if f), file=err)

    profile = None
    if trace and dev.type == "cuda":
        prof_inputs = [draws.inputs(cfg, 3, j) for j in range(PROFILED_REQUESTS)]

        def profiled_requests() -> int:
            for x in prof_inputs:
                prover.request(x)
            return len(prof_inputs)

        profile = prof.profiled(profiled_requests, PROGRAM_LOGGER)

    memory_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    for d in checked:
        d.settings = prover.serde.settings_to_flat_bytes(d.settings)
    del prover
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t_check = time.perf_counter()
    verifier = Verifier()
    numbers, statements, codes = checks.judge(
        cell, weights, done, checked, failed, pcs, lambda i: draws.inputs(cfg, 1, i), verifier)
    print(f"portbench: set-up {setup_s:.3f} s, window {window_s:.3f} s ({len(done)} requests), "
          f"check {time.perf_counter() - t_check:.3f} s ({len(checked)} proofs verified)", file=err)
    if not done:
        numbers["requests_failed"] = max(numbers["requests_failed"], 1)
    for i, (code, msg) in codes.items():
        if code:
            print(f"portbench: request {i}: the verifier rejects its proof: {msg}", file=err)
    correct = checks.verdict(numbers) and bool(done)

    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": 1, "memory_peak_bytes": int(memory_peak)}
    metrics, breakdown = {}, None
    if not trace and done:
        values = {
            "proved_cells_per_s": sum(st.cells for st in statements) / window_s,
            "proof_p90_s": nearest_rank([d.seconds for d in done], 0.9),
            "setup_s": setup_s,
        }
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    elif trace and done:
        work = {}
        if profile is not None:
            device_info.update(busy_s=profile.busy_s, window_s=profile.window_s)
            breakdown = profile.breakdown()
            for x in prof_inputs:
                st = checks.statement_of(cell.reference.forward(cfg, weights, x)[1])
                for part, w in work_mod.request(st, pcs).items():
                    work[part] = work.get(part, work_mod.Work()) + w
        readings = Readings(done, profile, work)
        for m in cell.per_layer:
            v = cell.readers[m["name"]].read(readings)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    result = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {k: {"value": v, "limit": checks.LIMITS[k]} for k, v in numbers.items()}
    return result


def forbidden_modules() -> List[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))
