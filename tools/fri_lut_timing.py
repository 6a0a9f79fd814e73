"""K3 (the FRI folds) and T4 (the LUT boundary) of the port on the card, in
the design of whichever tree is given, so that two commits can be measured
in turns in one run on one card.

    python3 tools/fri_lut_timing.py [--tree DIR]

DIR (default: this repository) is the root of a checkout whose
luminair_tpu_torch is imported; the measurement code (this file and
chip_smoke.py's graph, timers and work counts) is this repository's.  On
the black-scholes PINN at batch 256 (chip_smoke.py's graph) it runs the
settings pass, the trace and one prove on the card, keeping the FRI
commit chain's inputs and the LUT round trips' arguments, then prints one
JSON line each:

  settings   the settings pass's sub-spans (graph/device_trace.py; the LUT
             round trip's parts among them), 3 runs after a warm-up, and the
             device time of its T4 launches (torch.profiler);
  fri_chain  one commit chain (pcs/fri.commit_chain) on the kept inputs
             under torch.profiler: K3's device ms and launches, the chain's
             device ms, and the device memory it allocates above what it
             started from; beside them the chain's K3 bound as what it
             needs (chip_smoke.fri_layer_work over the circle fold of the
             largest input and each committed layer);
  fri_calls  K3 at the PINN's first committed layer (line log kmax - 1, its
             folds and the inputs that join them) in the tree's form: the
             earlier design's one launch a fold (and, apart, the circle
             folds of the joining inputs) or one launch a layer; and the
             circle fold of the largest input; CUDA-event median of 7;
  lut_call   T4 at the settings pass's largest LUT source: the wrapper's
             call ms (events), its host time per call (50 calls enqueued,
             wall over 50) and its kernel's device ms (profiled, 50 calls),
             torch.aminmax and the composition the boundary replaces
             (aminmax + cat) the same way, and the round trip to the host
             (the tree's form, and the composition with a pageable copy).

Each line names the card and its power limit (nvidia-smi).
"""

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke  # noqa: E402

REPS = 50  # calls per profiled or enqueued batch


def device_ms(run, names) -> dict:
    """One call of `run` under torch.profiler: device ms and launches of the
    kernels whose names hold any of `names` (in all and by name), and of
    every kernel."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    ms = count = all_ms = 0.0
    by_name = {}
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "CPU")).endswith("CPU"):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        all_ms += us / 1e3
        if any(n in e.key for n in names):
            ms += us / 1e3
            count += e.count
            by_name[e.key[:80]] = [us / 1e3, e.count]
    return {"ms": ms, "launches": int(count), "all_kernels_ms": all_ms, "by_name": by_name}


def per_call(fn) -> dict:
    """REPS calls of fn: the host's wall per call while enqueueing them (no
    synchronise inside), and the device ms per call of every kernel they
    launched."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(REPS):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3 / REPS
    torch.cuda.synchronize()
    d = device_ms(lambda: [fn() for _ in range(REPS)], ())
    return {"call_ms": chip_smoke.time_ms(fn), "host_ms_per_call": host_ms,
            "device_ms_per_call": d["all_kernels_ms"] / REPS}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(ROOT))
    tree = Path(ap.parse_args().tree).resolve()
    if not torch.cuda.is_available():
        print("fri_lut_timing: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(tree))
    from luminair_tpu_torch import kernels, tracing
    from luminair_tpu_torch import prelude as T
    from luminair_tpu_torch.models import black_scholes as BS
    from luminair_tpu_torch.pcs import fri

    if Path(kernels.__file__).resolve().parent.parent != tree:
        raise AssertionError(f"imported {kernels.__file__}, not the tree's")
    layer_form = hasattr(fri, "fold_layer")
    card = chip_smoke.phase_card()
    kernels.load_all()
    dev = torch.device("cuda", 0)
    head = {"tree": str(tree), "card": card, "form": "layer" if layer_form else "fold"}

    def emit(line):
        chip_smoke.emit({**head, **line})

    # The settings pass, keeping its largest LUT round trip's arguments.
    lut = {}
    if layer_form:
        real_boundary = kernels.lut_boundary

        def boundary(src, gathered, out):
            if len(src) > len(lut.get("src", ())):
                lut.update(src=src.clone(), gathered=gathered.clone(), out=out)
            return real_boundary(src, gathered, out)

        kernels.lut_boundary = boundary
    else:
        real_minmax, real_cat = kernels.lut_minmax, torch.cat

        def minmax(buf):
            mm = real_minmax(buf)
            if len(buf) > len(lut.get("src", ())):
                lut.update(src=buf.clone(), mm=mm)
            return mm

        def cat(ts, *args, **kw):  # the parent's round trip: cat([min/max, gathered])
            if isinstance(ts, list) and len(ts) == 2 and ts[0] is lut.get("mm"):
                lut["gathered"] = ts[1].clone()
            return real_cat(ts, *args, **kw)

        kernels.lut_minmax, torch.cat = minmax, cat
    cx, _ = chip_smoke.pinn_graph(T, BS)
    settings = T.gen_circuit_settings(cx)
    if layer_form:
        kernels.lut_boundary = real_boundary
    else:
        kernels.lut_minmax, torch.cat = real_minmax, real_cat
    spans = []
    for _ in range(3):
        cx, _ = chip_smoke.pinn_graph(T, BS)
        torch.cuda.synchronize()
        T.gen_circuit_settings(cx)
        spans.append(tracing.last_phases("settings"))
    cx, _ = chip_smoke.pinn_graph(T, BS)
    t4 = device_ms(lambda: T.gen_circuit_settings(cx), ("lut_minmax", "lut_boundary"))
    emit({"phase": "settings", "spans_s": spans, "t4_device_ms": t4["ms"], "t4_launches": t4["launches"],
          "all_kernels_ms": t4["all_kernels_ms"]})

    # One prove, keeping the commit chain's arguments.
    chain = {}
    real_chain = fri.commit_chain

    def keep(inputs, last_line_log, folds, digest, counter):
        chain.update(inputs={k: v.clone() for k, v in inputs.items()}, args=(last_line_log, folds, digest, counter))
        return real_chain(inputs, last_line_log, folds, digest, counter)

    fri.commit_chain = keep
    T.prove(T.gen_trace(cx, settings), settings)
    fri.commit_chain = real_chain
    inputs, (last_line_log, folds, digest, counter) = chain["inputs"], chain["args"]
    logs = sorted(inputs, reverse=True)
    kmax = logs[0]
    run_chain = lambda: fri.commit_chain(inputs, last_line_log, folds, digest, counter)  # noqa: E731
    run_chain()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    run_chain()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    k3 = device_ms(run_chain, ("fri_fold", "fri_layer"))
    schedule = fri.layer_schedule(kmax, last_line_log, folds)
    works = [chip_smoke.fri_layer_work({"values": inputs[kmax], "twiddles": [None], "mixes": None})]
    for log, f in schedule:
        rows = torch.empty((1 << log, 0))
        works.append(chip_smoke.fri_layer_work({
            "values": rows, "twiddles": [None] * f,
            "mixes": [(inputs[log - t], None) if log - t in inputs else None for t in range(f)]}))
    bound_ms = sum(chip_smoke.bound(*w)[0] for w in works)
    emit({"phase": "fri_chain", "input_logs": logs, "schedule": schedule, "k3_device_ms": k3["ms"],
          "k3_launches": k3["launches"], "k3_by_kernel": k3["by_name"], "chain_device_ms": k3["all_kernels_ms"],
          "chain_peak_bytes_above_start": peak,
          "k3_bound_ms": bound_ms, "k3_bound_bytes": sum(w[0] for w in works),
          "k3_bound_ops": sum(w[1] for w in works)})

    # K3's calls at the first committed layer and the largest input's circle fold.
    rng = torch.Generator().manual_seed(5)
    alpha0, alpha = (torch.randint(0, (1 << 31) - 1, (4,), generator=rng, dtype=torch.int32).to(dev) for _ in range(2))
    cur = fri.fold_circle_to_line(inputs[kmax], kmax, alpha0)
    L, F = schedule[0]
    joins = [L - t for t in range(F) if L - t in inputs]
    line = {"phase": "fri_calls", "layer": [L, F], "joining_inputs": joins,
            "circle_fold_ms": chip_smoke.time_ms(lambda: fri.fold_circle_to_line(inputs[kmax], kmax, alpha0)),
            "circle_fold_bound_ms": chip_smoke.bound(*works[0])[0], "layer_bound_ms": chip_smoke.bound(*works[1])[0]}
    if layer_form:
        line["layer_ms"] = chip_smoke.time_ms(lambda: fri.fold_layer(cur, kmax, L, F, alpha, alpha0, inputs))
    else:
        def line_evals():
            return {k - 1: fri.fold_circle_to_line(inputs[k], k, alpha0) for k in joins}

        evals = line_evals()

        def folds_of_layer():
            v = cur
            for t in range(F):
                v = fri.fold_line(v, kmax, L - t, alpha, t, evals.get(L - t - 1))
            return v

        line["layer_folds_ms"] = chip_smoke.time_ms(folds_of_layer)
        line["joining_circle_folds_ms"] = chip_smoke.time_ms(line_evals)
    emit(line)

    # T4 at the largest LUT source, beside the composition it replaces.
    src, gathered = lut["src"], lut["gathered"]

    def composition():
        return torch.cat([torch.stack(torch.aminmax(src)), gathered])

    line = {"phase": "lut_call", "src": len(src), "gathered": len(gathered),
            "bound_ms": chip_smoke.bound(8 * len(src) + 16 * len(gathered) + 16, 2 * len(src),
                                         chip_smoke.INT64_OPS_PER_S)[0],
            "aminmax": per_call(lambda: torch.aminmax(src)),
            "composition": per_call(composition)}
    if layer_form:
        out = lut["out"]
        pinned = torch.empty(len(gathered) + 2, dtype=torch.int64, pin_memory=True)
        line["kernel"] = per_call(lambda: kernels.lut_boundary(src, gathered, out))

        def round_trip():
            pinned.copy_(kernels.lut_boundary(src, gathered, out), non_blocking=True)
            torch.cuda.current_stream().synchronize()
    else:
        line["kernel"] = per_call(lambda: kernels.lut_minmax(src))

        def round_trip():
            torch.cat([kernels.lut_minmax(src), gathered]).cpu()
    line["round_trip_ms"] = chip_smoke.time_ms(round_trip)
    line["composition_round_trip_ms"] = chip_smoke.time_ms(lambda: composition().cpu())
    emit(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
