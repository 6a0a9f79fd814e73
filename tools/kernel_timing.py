"""Kernels of the port timed on the card at the black-scholes PINN's calls
(batch 256, chip_smoke.py's graph), in the design of whichever tree is
given, so that two commits can be measured in turns in one run on one card.

    python3 tools/kernel_timing.py [--tree DIR] [--kernels K3,T4,K8,K10,prove,K5,K6,air_check,carry,logup_sum,mesh_devices]

DIR (default: this repository) is the root of a checkout whose
luminair_tpu_torch is imported; the measurement code (this file and
chip_smoke.py's graph, timers, work counts and profiled windows,
chip_smoke.Profiled) is this repository's.  --kernels picks from:

  T4   settings: the settings pass's sub-spans (graph/device_trace.py; the
       LUT round trip's parts among them), 3 runs after a warm-up, and the
       device time of its T4 launches; lut_call: T4 at the pass's largest
       LUT source -- the wrapper's call ms (events), its host time per call
       (50 calls enqueued, wall over 50) and its kernel's device ms (50
       calls profiled), torch.aminmax and the composition the boundary
       replaces (aminmax + cat) the same way, and the round trip to the
       host (the tree's form, and the composition with a pageable copy);
  K3   fri_chain: one FRI commit chain (pcs/fri.commit_chain) on a prove's
       inputs, profiled: K3's device ms and launches, the chain's device
       ms, the device memory it allocates above where it started, and the
       chain's K3 bound as what it needs (chip_smoke.fri_layer_work);
       fri_calls: K3 at the first committed layer (line log kmax - 1, its
       folds and the inputs that join them) in the tree's form (one launch
       a fold and the joining circle folds apart, or one launch a layer),
       and the circle fold of the largest input; CUDA-event median of 7;
  K8   prove, per profile (default: 5 PoW bits; high_security(): 16): one
  K10  prove with the counters reset just before it -- K8's launches and
       its steps in K2 root passes (where the tree has them), K2's and
       K10's launches; one profiled prove -- device ms and launches of K8's
       kernels (channel_*), K2's (merkle_pass_kernel) and K10's; where K8's
       steps run in root passes, each step as its root pass with it less
       without (chip_smoke.channel_steps) and K2 less the steps; the host
       seconds of 3b_fri_commit and 3b_pow over 5 proves; pow: K10 at the
       call that prove made -- call ms (CUDA events, median of 7), the
       host's wall a call over 50 calls, the device ms a call and every
       device record of those 50 calls (kernels and copies, by name);
  trace_segment
       the settings pass's and the trace's segments, each alone from fresh
       outputs (device ms a launch, the mean of 5), with csrc/ built as it
       is and in variants that each undo one choice of trace.cu /
       trace.cuh (copies under build/variants/), and at other tile limits
       (kernels.SEG_MAX_TILES); the build as it is runs first and again
       last (their drift is the yardstick's noise);
  trace_encode
       the trace library's SASS (LDL, STL and instructions a kernel,
       cuobjdump -sass) and resources (registers, stack and local bytes a
       kernel, cuobjdump -res-usage); the settings pass's and the trace's
       segments of the PINN (batch 256) and of the bench graph at N = 2048
       (the `mul_add` cell's), each alone from fresh outputs (device ms a
       launch, the mean of 5), in ENCODE_ROUNDS rounds; where the tree has
       the encode item, one segment of two encode items of 2^22 values each
       (the bench graph's inputs at N = 2048) beside its bound in bytes;
  profiler_window
       where a profiled window loses device records: windows
       (chip_smoke.Profiled) of a prove, then of chip_smoke.LAUNCH_BATCH
       launches of K8's one-thread kernel; per window the host's records of
       launches and copies, the kernel's device records, the positions of
       the calls whose correlation id has no device record, and how far
       the device's records start before their calls' host records;
  prove
       one-device proves of bench_n256 and the PINN (5 PoW bits, 80-bit
       high_security(), log blowup 2) from their card PIEs: after a
       warm-up, PROVE_TIMES proves each timed to a synchronise (their
       median, and each phase's median from the tracing spans), and one
       profiled prove's device ms, in all and by device record (kernel or
       copy: [ms, count] under its name's first 80 characters), so that a change in
       the wall time can be told apart as the host's or the device's;
  K6   K5 and K6 on the PINN's mul component (chip_smoke.py's tape
       kernels): K5 at its 2^21 trace rows, K6 at its commit domain of
       blowup 1 and 2 (2^22 and 2^23 rows, stride 2 and 4) and at the
       second of its 4 row blocks with its halo (2^20 and 2^21 rows), each
       call's CUDA-event median of TAPE_REPS after a warm-up (and
       `per_call`'s call, host and device ms), on inputs drawn from one
       seed, beside its bound as chip_smoke.py counts it
       now and as it counted before; and the LDL / STL counts of the SASS
       of every kernel of the tree's air library (cuobjdump);
  K5   K5 in a prove of bench_n256 and of the PINN (their card PIEs):
       the witness calls of one prove recorded, then replayed (`per_call`:
       call, host and device ms of the prove's calls); where the tree has
       one launch a phase (kernels.air_witness_many), that launch again at
       each number of rows a thread (kernels.witness_items) from 1 to
       WITNESS_MAX_ITEMS;
  air_check
       the constraint check: the one-component call at mul's 2^21 trace
       rows (chip_smoke.py's tape kernels' inputs) and the check launches
       of one check_pie_constraints of the PINN's card PIE (recorded from
       one run, then replayed: the tree's one launch of every component,
       or its launch a component) -- each the CUDA-event call ms, the
       host's wall a call over REPS enqueued calls and the device ms a
       call; the whole check_pie_constraints (host seconds, median of
       PROVE_TIMES; one profiled call's device records); and the count of
       local-memory loads and stores (LDL, STL) and of all instructions in
       the SASS of each kernel of the tree's air library (cuobjdump);
  carry
       the PINN proved over 4 shards of the card (a virtual mesh): the
       carry pass's launches by shard, PROVE_TIMES proves (the median, and
       phase2_interaction's median), and one profiled prove's device ms
       and launches of the carry pass and of K5;
  logup_sum
       logup_sum at prover_step's full width (2 relation columns, 2^21
       rows; chip_smoke.step_inputs): its call ms, the host's wall a call
       over REPS enqueued calls and its device ms a call (REPS calls
       profiled), beside its bound, and the same for a call of a plan
       built once where the tree has kernels.LogupPlan; the LogUp part of
       a 4-shard prover_step at that width in four pieces (logup_split);
       prover_step's host ms (median of PROVE_TIMES, each to a
       synchronise) over 1, 2 and 4 shards and 2 x 2 of the card;
  mesh_devices
       the bench graph's and the PINN's card PIEs proved over the
       machine's distinct cards (chip_smoke.phase_mesh_devices: 2 and 4
       shards where there are that many cards; one line saying that
       nothing ran below two): the one-device bytes, native/ accepting,
       seconds beside one device, bytes gathered, moved and scattered,
       peak memory by card, the cumsum and carry copies in the host's
       records;

Each line names the card and its power limit (nvidia-smi).
"""

import argparse
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402

REPS = 50  # calls per profiled or enqueued batch
PROVES = 5
PROVE_TIMES = 9  # timed proves a path (`prove`)
TAPE_REPS = 31  # timed calls of a tape kernel (`K6`)
KINDS = ("K3", "T4", "K8", "K10", "trace_segment", "trace_encode", "profiler_window", "prove", "K5", "K6",
         "air_check", "carry", "logup_sum", "mesh_devices")
ENCODE_ROUNDS = 3  # rounds of the segments' timings (`trace_encode`)
ENCODE_N = 2048  # the bench graph's side (`trace_encode`): the mul_add cell's

# Design choices of the trace segment kernel, each undone in a copy of csrc/.
VARIANTS = {
    "plain_stores": ("trace.cuh", "__stcs((unsigned int*)p, v);", "*p = v;"),
    "mod_to_m31": ("trace.cuh", "const unsigned long long u = (unsigned long long)v ^ (1ull << 63);",
                   "long long m = v % M31_P; return (uint32_t)(m < 0 ? m + M31_P : m);\n"
                   "  const unsigned long long u = (unsigned long long)v ^ (1ull << 63);"),
    "poll_32ns": ("trace.cu", "__nanosleep(256)", "__nanosleep(32)"),
    "grid_2_per_sm": ("trace.cu", "fit[dev] = (long long)per_sm * sms;",
                      "fit[dev] = (long long)(per_sm < 2 ? per_sm : 2) * sms;"),
    "l2_reads": ("trace.cuh", "return fresh ? __ldcg(p) : __ldg(p);", "return __ldcg(p);"),
}


def device_ms(run, names) -> dict:
    """One call of `run`, profiled: device ms and launches of the kernels
    whose names hold any of `names` (in all and by name), and of every
    kernel."""
    ms = count = all_ms = 0.0
    by_name = {}
    for key, (m, n) in chip_smoke.Profiled(run).device.items():
        all_ms += m
        if any(name in key for name in names):
            ms += m
            count += n
            by_name[key[:80]] = [m, n]
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


def settings_t4(kernels, T, BS, tracing, emit, layer_form: bool) -> None:
    """The settings pass's spans and T4 (the `T4` lines above)."""
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

        def cat(ts, *args, **kw):  # the earlier round trip: cat([min/max, gathered])
            if isinstance(ts, list) and len(ts) == 2 and ts[0] is lut.get("mm"):
                lut["gathered"] = ts[1].clone()
            return real_cat(ts, *args, **kw)

        kernels.lut_minmax, torch.cat = minmax, cat
    cx, _ = chip_smoke.pinn_graph(T, BS)
    T.gen_circuit_settings(cx)
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


def fri_k3(T, fri, pie, settings, dev, emit, layer_form: bool) -> None:
    """K3 on a prove's commit chain (the `K3` lines above)."""
    chain = {}
    real_chain = fri.commit_chain

    def keep(inputs, last_line_log, folds, digest, counter):
        chain.update(inputs={k: v.clone() for k, v in inputs.items()}, args=(last_line_log, folds, digest, counter))
        return real_chain(inputs, last_line_log, folds, digest, counter)

    fri.commit_chain = keep
    T.prove(pie, settings)
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
    emit({"phase": "fri_chain", "input_logs": logs, "schedule": schedule, "k3_device_ms": k3["ms"],
          "k3_launches": k3["launches"], "k3_by_kernel": k3["by_name"], "chain_device_ms": k3["all_kernels_ms"],
          "chain_peak_bytes_above_start": peak,
          "k3_bound_ms": sum(chip_smoke.bound(*w)[0] for w in works), "k3_bound_bytes": sum(w[0] for w in works),
          "k3_bound_ops": sum(w[1] for w in works)})

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


def channel_pow(kernels, T, tracing, pie, settings, emit, kinds) -> None:
    """K8 and K10 in a prove at each profile (the `K8`, `K10` lines above)."""
    fused = hasattr(kernels.CHANNEL, "hosted")
    names = ("channel_", "merkle_pass_kernel", "grind_pow")
    for tag, cfg in (("pinn_b256", None), ("pinn_b256_hs", T.PcsConfig.high_security())):
        calls, kept = [], {}
        real_grind, real_tree, real_draw = kernels.grind_pow, kernels.merkle_tree, kernels.channel_draw_felt

        def grind(*args):
            calls.append(args)
            return real_grind(*args)

        def tree(desc, state=None, slot=None):  # the change's channel trees, as chip_smoke keeps them
            if state is not None:
                kept[("merkle_tree", len(kept))] = {"desc": desc, "state": state.clone()}
            return real_tree(desc, state, slot)

        def draw(state, out=None):
            kept[("channel_draw_felt",)] = {"state": state.clone(), "out": out}
            return real_draw(state, out)

        kernels.grind_pow = grind
        if fused:
            kernels.merkle_tree, kernels.channel_draw_felt = tree, draw
        T.prove(pie, settings, cfg)  # warm-up, and the calls' arguments
        kernels.grind_pow, kernels.merkle_tree, kernels.channel_draw_felt = real_grind, real_tree, real_draw
        if "K8" in kinds:
            kernels.reset_counts()
            proof = T.prove(pie, settings, cfg)
            torch.cuda.synchronize()
            counts = kernels.counts()
            steps = getattr(kernels.CHANNEL, "hosted", 0)
            spans = []
            for _ in range(PROVES):
                T.prove(pie, settings, cfg)
                torch.cuda.synchronize()
                spans.append(tracing.last_phases("prove"))
            prof = device_ms(lambda: T.prove(pie, settings, cfg), names)
            by_kernel = {n: [sum(v[0] for k, v in prof["by_name"].items() if n in k),
                             sum(v[1] for k, v in prof["by_name"].items() if n in k)] for n in names}
            line = {"phase": "prove", "path": tag, "fri_layers": len(proof.pcs_proof.fri_proof.layer_roots),
                    "k8_launches": counts["fri_channel"], "k8_steps_in_root_passes": steps,
                    "k2_launches": counts["blake2s_merkle"], "k10_launches": counts["grind_pow"],
                    "device_ms_and_launches": by_kernel, "prove_device_ms": prof["all_kernels_ms"],
                    "fri_commit_host_s": [p["3b_fri_commit"] for p in spans],
                    "pow_host_s": [p["3b_pow"] for p in spans]}
            line["fri_commit_host_s_median"] = statistics.median(line["fri_commit_host_s"])
            line["pow_host_s_median"] = statistics.median(line["pow_host_s"])
            if fused:
                ch = chip_smoke.channel_steps(kernels, kept)
                steps_ms = sum(st["device_ms"] for st in ch["steps"])
                line.update(k8_step_device_ms=[st["device_ms"] for st in ch["steps"]],
                            k8_device_ms=by_kernel["channel_"][0] + steps_ms,
                            k2_device_ms_less_steps=by_kernel["merkle_pass_kernel"][0] - steps_ms)
            emit(line)
        if "K10" in kinds:
            args = calls[0]
            fn = lambda: kernels.grind_pow(*args)  # noqa: E731
            nonce = fn()
            events = device_ms(lambda: [fn() for _ in range(REPS)], ("",))
            emit({"phase": "pow", "path": tag, "bits": args[1], "nonce": nonce, **per_call(fn),
                  "device_events_per_call": {k: [ms / REPS, c / REPS] for k, (ms, c) in events["by_name"].items()},
                  "bound_ms": chip_smoke.bound(40, (nonce + 1) * chip_smoke.OPS_POW_CANDIDATE)[0]})


def prove_times(T, BS, tracing, emit) -> None:
    """One-device proves (the `prove` lines above)."""
    bench, _ = chip_smoke.bench_graph(T, 256)
    pinn, _ = chip_smoke.pinn_graph(T, BS)
    inputs = {}
    for tag, cx in (("bench_n256", bench), ("pinn_b256", pinn)):
        settings = T.gen_circuit_settings(cx)
        inputs[tag] = (T.gen_trace(cx, settings), settings)
    paths = (("bench_n256", None), ("pinn_b256", None), ("pinn_b256_hs", T.PcsConfig.high_security()),
             ("pinn_b256_b2", T.PcsConfig(fri=T.FriConfig(log_blowup_factor=2))))
    for tag, cfg in paths:
        pie, settings = inputs[tag if tag == "bench_n256" else "pinn_b256"]
        T.prove(pie, settings, cfg)  # warm-up
        torch.cuda.synchronize()
        times, phases = [], []
        for _ in range(PROVE_TIMES):
            t0 = time.perf_counter()
            T.prove(pie, settings, cfg)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            phases.append(tracing.last_phases("prove"))
        dev = device_ms(lambda: T.prove(pie, settings, cfg), ("",))
        emit({"phase": "prove", "path": tag, "prove_s": times, "prove_s_median": statistics.median(times),
              "phases_s_median": {k: statistics.median(p.get(k, 0.0) for p in phases) for k in phases[0]},
              "prove_device_ms": dev["all_kernels_ms"], "device_ms_by_name": dev["by_name"]})


def tape_times(kernels, emit, dev) -> None:
    """The `K6` lines above."""
    from luminair_tpu_torch.air import tape
    from luminair_tpu_torch.air.components import COMPONENTS_BY_NAME

    emit({"phase": "air_sass", "library": kernels.AIR_WITNESS.library_path().name,
          "kernels": sass_counts(kernels.AIR_WITNESS.library_path())})
    comp, log = COMPONENTS_BY_NAME["mul"], 21
    rng = np.random.default_rng(21)

    def rnd(*shape):
        return torch.from_numpy(rng.integers(0, (1 << 31) - 1, size=shape, dtype=np.int64).astype(np.int32)).to(dev)

    def words(k):
        return tuple(int(x) for x in rng.integers(0, (1 << 31) - 1, k))

    ew = [[words(4) for _ in range(2)] for _ in tape.ELEM_KINDS]
    tpw, tpd = tape.record(comp, witness=True), tape.record(comp)
    main, pp = [rnd(1 << log) for _ in comp.MAIN], [rnd(1 << log) for _ in comp.PP_IDS]
    wa = {"comps": [(tpw, main, pp)]}
    calls = {f"air_witness 2^{log}": (lambda: kernels.air_witness(tpw, main, pp, ew),
                                      chip_smoke.witness_work(wa), chip_smoke.witness_work(wa, False))}
    for blowup in (1, 2):
        m = 1 << (log + blowup)
        args = (tpd, [rnd(m) for _ in comp.MAIN], [rnd(m) for _ in comp.PP_IDS],
                [rnd(m) for _ in range(4 * tpd.n_relations)], rnd(m), words(4), ew,
                [words(4) for _ in range(tpd.n_pows)], log, 1 << blowup)
        # Bounds where the tree has K6's blocks (chip_smoke.domain_work reads them).
        da = chip_smoke.domain_call(args) if hasattr(kernels, "DomainBlock") else None
        calls[f"air_domain 2^{log + blowup}, stride {1 << blowup}"] = (
            lambda args=args: kernels.air_domain(*args), da and chip_smoke.domain_work(da),
            da and chip_smoke.domain_work(da, True))
        # The row block of shard 1 of 4 with its halo (PR 14's mesh block).
        R, stride = m // 4, 1 << blowup
        part = slice(R, 2 * R)
        halo = ({x: args[1][x][2 * R : 2 * R + stride] for x in tpd.next_cols},
                [c[R - stride : R] for c in args[3][-4:]])
        block = (tpd, [c[part] for c in args[1]], [c[part] for c in args[2]], [c[part] for c in args[3]],
                 args[4][part]) + args[5:]
        db = None
        if da:
            term = kernels.DomainTerm(tpd, *[list(x) for x in block[1:4]], block[4], args[5], list(args[7]), halo)
            db = {"blocks": [kernels.DomainBlock([term], log, stride, R, log + blowup)]}
        calls[f"air_domain block of 2^{log + blowup - 2} rows with its halo, stride {stride}"] = (
            lambda block=block, halo=halo, R=R, blowup=blowup: kernels.air_domain(
                *block, row0=R, log_domain=log + blowup, halo=halo),
            db and chip_smoke.domain_work(db), db and chip_smoke.domain_work(db, True))
    for name, (call, work, before) in calls.items():
        line = {"phase": "tape", "call": name, "ms": chip_smoke.time_ms(call, TAPE_REPS), **per_call(call)}
        if work is not None:
            line.update(bound_ms=chip_smoke.bound(*work)[0], bound_before_ms=chip_smoke.bound(*before)[0])
        emit(line)


def witness_times(kernels, T, BS, emit) -> None:
    """The `K5` lines above."""
    cx, _ = chip_smoke.bench_graph(T, chip_smoke.N_MAIN)
    bench = T.gen_circuit_settings(cx)
    inputs = {"bench_n256": (T.gen_trace(cx, bench), bench), "pinn_b256": _pinn_pie(T, BS)}
    many = hasattr(kernels, "air_witness_many")
    name = "air_witness_many" if many else "air_witness"
    for tag, (pie, settings) in inputs.items():
        orig, kept = getattr(kernels, name), []

        def rec(*a, **k):
            kept.append((a, k))
            return orig(*a, **k)

        setattr(kernels, name, rec)
        try:
            T.prove(pie, settings)
        finally:
            setattr(kernels, name, orig)
        rows = sum((list(c[1]) + list(c[2]))[0].shape[0] for a, _ in kept for c in a[0]) if many else sum(
            (list(a[1]) + list(a[2]))[0].shape[0] for a, _ in kept)
        emit({"phase": "witness", "path": tag, "calls_a_prove": len(kept), "rows": rows,
              **({"items_default": kernels.witness_items(rows)} if many else {}),
              **per_call(lambda: [orig(*a, **k) for a, k in kept])})
        if not many:
            continue
        default = kernels.witness_items
        for items in range(1, kernels.WITNESS_MAX_ITEMS + 1):
            kernels.witness_items = lambda rows, items=items: items
            try:
                emit({"phase": "witness", "path": tag, "items": items, **per_call(lambda: orig(*kept[0][0]))})
            finally:
                kernels.witness_items = default


def _pinn_pie(T, BS):
    cx, _ = chip_smoke.pinn_graph(T, BS)
    settings = T.gen_circuit_settings(cx)
    return T.gen_trace(cx, settings), settings


def sass_counts(lib: Path) -> dict:
    """{kernel (mangled name): {"LDL": n, "STL": n, "instructions": n}} of
    the SASS of one kernel library (cuobjdump -sass)."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([cuobjdump, "-sass", str(lib)], check=True, capture_output=True, text=True,
                          timeout=300).stdout
    out, cur = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = out.setdefault(m.group(1), {"LDL": 0, "STL": 0, "instructions": 0})
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[0-9T]\s+)?([A-Z][A-Z0-9_]*)", line)
        if cur is not None and m:
            cur["instructions"] += 1
            if m.group(1) in ("LDL", "STL"):
                cur[m.group(1)] += 1
    return out


def check_times(kernels, T, BS, emit, dev) -> None:
    """The `air_check` lines above."""
    from luminair_tpu_torch.air import tape
    from luminair_tpu_torch.air.components import COMPONENTS_BY_NAME
    from luminair_tpu_torch.air.debug import check_pie_constraints

    emit({"phase": "air_check_sass", "library": kernels.AIR_CHECK.library_path().name,
          "kernels": sass_counts(kernels.AIR_CHECK.library_path())})
    comp, log = COMPONENTS_BY_NAME["mul"], 21
    rng = np.random.default_rng(21)

    def rnd(n):
        return torch.from_numpy(rng.integers(0, (1 << 31) - 1, size=n, dtype=np.int64).astype(np.int32)).to(dev)

    tp, n = tape.record(comp), 1 << log
    ew = [[tuple(int(x) for x in rng.integers(0, (1 << 31) - 1, 4)) for _ in range(2)] for _ in tape.ELEM_KINDS]
    cargs = (tp, [rnd(n) for _ in comp.MAIN], [rnd(n) for _ in comp.PP_IDS],
             [rnd(n) for _ in range(4 * tp.n_relations)], rnd(n), tuple(int(x) for x in rng.integers(0, 7, 4)), ew)
    emit({"phase": "air_check", "call": f"mul, 2^{log} rows, one component", "launches_a_call": 1,
          **per_call(lambda: kernels.air_check(*cargs))})
    del cargs
    pie, settings = _pinn_pie(T, BS)
    name = "air_check_many" if hasattr(kernels, "air_check_many") else "air_check"
    orig, kept = getattr(kernels, name), []

    def rec(*a, **k):
        kept.append((a, k))
        return orig(*a, **k)

    setattr(kernels, name, rec)
    try:
        check_pie_constraints(pie, settings)
    finally:
        setattr(kernels, name, orig)
    before = kernels.AIR_CHECK.launches
    orig(*kept[0][0], **kept[0][1])
    per_wrapper_call = kernels.AIR_CHECK.launches - before
    emit({"phase": "air_check", "call": f"the PINN's check: {len(kept)} call(s) of kernels.{name}",
          "launches_a_check": per_wrapper_call * len(kept),
          **per_call(lambda: [orig(*a, **k) for a, k in kept])})
    del kept
    times = []
    for _ in range(PROVE_TIMES):
        t0 = time.perf_counter()
        check_pie_constraints(pie, settings)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    emit({"phase": "air_check", "call": "check_pie_constraints of the PINN's card PIE", "seconds": times,
          "seconds_median": statistics.median(times),
          "device": device_ms(lambda: check_pie_constraints(pie, settings), ("check", "air_witness", "scan_tile"))})


def carry_times(kernels, T, BS, tracing, emit, dev) -> None:
    """The `carry` lines above."""
    from luminair_tpu_torch.parallel import sharding as S

    pie, settings = _pinn_pie(T, BS)
    mesh = S.make_chip_mesh(4, devices=[dev] * 4)
    with S.prove_mesh(mesh):
        T.prove(pie, settings)  # warm-up
        torch.cuda.synchronize()
        kernels.reset_counts()
        T.prove(pie, settings)
        by_shard = {str(k): v.get("add_carry", 0) for k, v in kernels.SHARD_LAUNCHES.items()}
        times, phase2 = [], []
        for _ in range(PROVE_TIMES):
            t0 = time.perf_counter()
            T.prove(pie, settings)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            phase2.append(tracing.last_phases("prove").get("phase2_interaction"))
        dev_ms = device_ms(lambda: T.prove(pie, settings), ("add_carry", "air_witness", "scan_tile"))
    emit({"phase": "carry", "path": "pinn_b256 over 4 shards of the card", "add_carry_launches_by_shard": by_shard,
          "prove_s": times, "prove_s_median": statistics.median(times), "phase2_interaction_s": phase2,
          "phase2_interaction_s_median": statistics.median(phase2), "device": dev_ms})


def _host_ms(fn, reps: int = PROVE_TIMES) -> float:
    """Median host wall of fn followed by a synchronise, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


class _no_launch:
    """While active, logup_sum's launches are skipped (the host's work
    before each launch alone): the tree's launch method replaced."""

    def __init__(self, kernels):
        self.k = kernels.LOGUP_SUM
        self.attr = "run" if hasattr(self.k, "run") else "launch"

    def __enter__(self):
        setattr(self.k, self.attr, lambda *a: None)

    def __exit__(self, *exc):
        delattr(self.k, self.attr)


def logup_split(kernels, emit, dev, cols, mult, z, alpha) -> None:
    """The LogUp part of a 4-shard prover_step at full width on a virtual
    mesh of the card (sharding._logup_sum_body), in four pieces, each
    ended by a synchronise: the shards' rows to the card (the parent: a
    numpy slice and a pageable upload a shard; the change: the staged
    copies), the wrapper's host work before each launch (launches
    skipped), the device time of the launches, and the lead's copies and
    adds; then the whole body (host wall to a synchronise, CUDA events,
    one profiled call: the host's add records and the device's)."""
    from luminair_tpu_torch import fields as f
    from luminair_tpu_torch.parallel import sharding as S

    mesh = S.make_chip_mesh(4, devices=[dev] * 4)
    values = cols[: chip_smoke.MESH_REL_COLS]
    bounds = [(a, b) for a, b in S.split_evenly(values.shape[1], 4) if a < b]
    planned = hasattr(kernels, "LogupPlan")
    if planned:
        shards = [(p, d, a, b) for (p, d), (a, b) in zip(mesh.row_shards(), bounds)]

        def upload():
            return [(r[:-1], r[-1]) for r in S._shard_rows(values, mult, shards)]

        def calls(ups):
            plan = kernels.LogupPlan(z, alpha, values.shape[0])
            parts = torch.empty((len(ups), 4), dtype=f.I32, device=dev)
            for i, (v, m) in enumerate(ups):
                plan(v, m, parts[i])
            return parts

        def lead(parts):
            return S.lead_sum(parts)
    else:
        def upload():
            return [(f.u32_to_tensor(values[:, a:b], dev), f.u32_to_tensor(mult[a:b], dev)) for a, b in bounds]

        def calls(ups):
            return [kernels.logup_sum(v, m, z, alpha) for v, m in ups]

        def lead(parts):
            total = torch.zeros(4, dtype=f.I64, device=dev)
            for part in parts:
                total = f.add(total, part.to(dev).to(f.I64))
            return total.to(f.I32)

    ups = upload()
    parts = calls(ups)
    torch.cuda.synchronize()
    with _no_launch(kernels):
        calls(ups)  # warm-up
        host = []
        for _ in range(PROVE_TIMES):
            t0 = time.perf_counter()
            calls(ups)
            host.append((time.perf_counter() - t0) * 1e3)
    body = chip_smoke.Profiled(lambda: S._logup_sum_body(mesh, values, mult, z, alpha))
    emit({"phase": "logup_split", "shards": 4, "shape": list(values.shape),
          "form": "plan" if planned else "a call a shard",
          "upload_ms": _host_ms(upload), "wrapper_host_ms": statistics.median(host),
          "device_ms": device_ms(lambda: calls(ups), ("logup_sum",))["ms"], "lead_ms": _host_ms(lambda: lead(parts)),
          "body_host_ms": _host_ms(lambda: S._logup_sum_body(mesh, values, mult, z, alpha)),
          "body_call_ms": chip_smoke.time_ms(lambda: S._logup_sum_body(mesh, values, mult, z, alpha)),
          "body_lead_adds": body.op_count("aten::add", "aten::add_", "aten::sum"),
          "body_device_ms": {k[:80]: v for k, v in body.device.items()}})


def logup_times(kernels, emit, dev) -> None:
    """The `logup_sum` lines above."""
    from luminair_tpu_torch import fields as f
    from luminair_tpu_torch.parallel import sharding as S

    n_cols, log = chip_smoke.MESH_STEP_SHAPES["full_width"]
    cols, mult, z, alpha = chip_smoke.step_inputs(n_cols, log)
    values = f.u32_to_tensor(cols[: chip_smoke.MESH_REL_COLS], dev)
    m = f.u32_to_tensor(mult, dev)
    line = {"phase": "logup_sum", "shape": [chip_smoke.MESH_REL_COLS, 1 << log],
            "bound_ms": chip_smoke.bound(*chip_smoke.logup_work(chip_smoke.MESH_REL_COLS, 1 << log))[0],
            **per_call(lambda: kernels.logup_sum(values, m, z, alpha))}
    if hasattr(kernels, "LogupPlan"):
        plan = kernels.LogupPlan(z, alpha, chip_smoke.MESH_REL_COLS)
        line["planned"] = per_call(lambda: plan(values, m))
    emit(line)
    logup_split(kernels, emit, dev, cols, mult, z, alpha)
    steps = {}
    for kind in chip_smoke.MESH_KINDS:
        mesh = chip_smoke.mesh_of(S, kind, [dev] * 4)
        steps[kind] = _host_ms(lambda: S.prover_step(mesh, cols, mult, z, alpha, n_rel_cols=chip_smoke.MESH_REL_COLS))
    emit({"phase": "prover_step", "shape": [n_cols, 1 << log], "host_ms_median": steps})


def mesh_devices(kernels, T, BS) -> None:
    """The `mesh_devices` lines above."""
    from luminair_tpu_torch import serde
    from luminair_tpu_torch.air import tape
    from luminair_tpu_torch.parallel import sharding as S

    card = chip_smoke.phase_card()
    for tag, build in (("bench_n256", lambda: chip_smoke.bench_graph(T, chip_smoke.N_MAIN)),
                       ("pinn_b256", lambda: chip_smoke.pinn_graph(T, BS))):
        cx, _ = build()
        settings = T.gen_circuit_settings(cx)
        pie = T.gen_trace(cx, settings)
        chip_smoke.phase_mesh_devices(T, S, kernels, serde, tape, card, tag, pie, settings, T.prove(pie, settings))


def trace_segment_variants(kernels, T, BS, tree: Path, emit) -> None:
    """The `trace_segment` lines above."""
    csrc = Path(kernels._CSRC)

    def use(src: Path, build: Path) -> None:
        kernels._CSRC, kernels.BUILD_DIR = src, build
        for k in kernels.KERNELS:
            k._fns = None
        kernels.load_all()

    builds, variants_dir = {"as_built": csrc}, tree / "build" / "variants"
    for name, (source, old, new) in VARIANTS.items():
        copy = variants_dir / name / "csrc"
        shutil.rmtree(copy, ignore_errors=True)
        shutil.copytree(csrc, copy)
        text = (copy / source).read_text()
        if text.count(old) != 1:
            raise AssertionError(f"{name}: {old!r} is not in {source} once")
        (copy / source).write_text(text.replace(old, new))
        builds[name] = copy
    builds["as_built_again"] = csrc
    build_dir, limit = kernels.BUILD_DIR, kernels.SEG_MAX_TILES
    for name, src in builds.items():
        use(src, variants_dir / name.replace("_again", "") / "kernels")
        segs = kept_segments(kernels, T, chip_smoke.pinn_graph(T, BS)[0])
        for tiles in ((limit, 4096, 1024) if name == "as_built" else (limit,)):
            kernels.SEG_MAX_TILES = tiles
            ms = [segment_device_ms(kernels, seg) for seg in segs]
            n_settings = sum(not seg.has_columns for seg in segs)
            emit({"phase": "trace_segment", "build": name, "seg_max_tiles": tiles, "device_ms": ms,
                  "settings_ms": sum(ms[:n_settings]), "trace_ms": sum(ms[n_settings:])})
        kernels.SEG_MAX_TILES = limit
    use(csrc, build_dir)


def res_usage(lib: Path) -> dict:
    """{kernel (mangled name): {"REG": n, "STACK": n, "LOCAL": n, ...}} of
    one kernel library (cuobjdump -res-usage)."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([cuobjdump, "-res-usage", str(lib)], check=True, capture_output=True, text=True,
                          timeout=300).stdout
    out, cur = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function (\S+):", line)
        if m:
            cur = m.group(1)
            continue
        if cur is not None and "REG:" in line:
            out[cur] = {k: int(v) for k, v in re.findall(r"([A-Z]+):(\d+)", line)}
            cur = None
    return out


def kept_segments(kernels, T, cx) -> list:
    """Every segment the card's settings pass and trace of `cx` launch."""
    kept, launch = [], kernels.trace_segment

    def keep(seg):
        kept.append(seg)
        return launch(seg)

    kernels.trace_segment = keep
    try:
        T.gen_trace(cx, T.gen_circuit_settings(cx))
    finally:
        kernels.trace_segment = launch
    return kept


def segment_device_ms(kernels, seg, n: int = 5) -> float:
    """Device ms a launch of `seg` from fresh outputs, the mean of n."""
    fresh = seg.fresh()
    kernels.trace_segment(fresh)
    p = chip_smoke.Profiled(lambda: [kernels.trace_segment(fresh) for _ in range(n)])
    count = p.count("trace_segment_kernel")
    if not count:
        raise AssertionError(f"trace_segment: no device record of {n} launches")
    return p.ms("trace_segment_kernel") / count


def trace_encode_times(kernels, T, BS, emit, dev) -> None:
    """The `trace_encode` lines above."""
    lib = kernels.TRACE_SEGMENT.library_path()
    emit({"phase": "trace_sass", "library": lib.name, "kernels": sass_counts(lib), "resources": res_usage(lib)})
    graphs = {"pinn_b256": lambda: chip_smoke.pinn_graph(T, BS)[0],
              f"bench_n{ENCODE_N}": lambda: chip_smoke.bench_graph(T, ENCODE_N)[0]}
    for tag, build in graphs.items():
        segs = kept_segments(kernels, T, build())
        n_settings = sum(not seg.has_columns for seg in segs)
        for r in range(ENCODE_ROUNDS):
            ms = [segment_device_ms(kernels, seg) for seg in segs]
            emit({"phase": "trace_segments", "graph": tag, "round": r, "device_ms": ms,
                  "settings_ms": sum(ms[:n_settings]), "trace_ms": sum(ms[n_settings:]),
                  "items": [[it.op for it in seg.items()].count("encode") for seg in segs]})
    if "encode" not in kernels.TRACE_OPS:
        return
    from luminair_tpu_torch.graph.view import View

    n = 1 << 22
    arena = torch.zeros(4 * n + kernels.NodeTable.n_words(2, 2, 1), dtype=torch.int64, device=dev)
    arena[: 2 * n] = torch.randn(2 * n, dtype=torch.float64, device=dev).view(torch.int64)
    view = View.contiguous((n,))
    items = [kernels.TraceItem("encode", n, ((k * n, n, view),), out=((2 + k) * n, n)) for k in (0, 1)]
    table = kernels.NodeTable(kernels.TraceBuffers(arena), items, [(0, 1), (1, 1)], [(0, 2)], [(0, 1)], 4 * n)
    table.upload()
    seg = table.segment(0)
    emit({"phase": "encode_alone", "values": 2 * n, "device_ms": [segment_device_ms(kernels, seg) for _ in range(3)],
          "bound_ms": chip_smoke.bound(16 * 2 * n, 0)[0], "bytes": 16 * 2 * n})


def profiler_window(kernels, T, pie, settings, dev, emit, windows: int = 4) -> None:
    """The `profiler_window` lines above."""
    n = chip_smoke.LAUNCH_BATCH
    state = torch.zeros(kernels.CHANNEL_WORDS, dtype=torch.int32, device=dev)
    out = torch.zeros(4, dtype=torch.int32, device=dev)
    kernels.channel_draw_felt(state, out)
    for w in range(windows):
        prove = chip_smoke.Profiled(lambda: T.prove(pie, settings))
        p = chip_smoke.Profiled(lambda: [kernels.channel_draw_felt(state, out) for _ in range(n)])
        emit({"phase": "profiler_window", "window": w, "launches": n, "host_records": p.host,
              "kernel_records": p.count("channel_draw_kernel"), "without_a_device_record": p.lost,
              "device_lead_us": p.device_lead_us, "prove_host_records": prove.host,
              "prove_without_a_device_record": prove.lost, "prove_device_lead_us": prove.device_lead_us})


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(ROOT))
    ap.add_argument("--kernels", default="K3,T4,K8,K10", help=f"a comma-separated list from {', '.join(KINDS)}")
    opts = ap.parse_args()
    tree = Path(opts.tree).resolve()
    kinds = opts.kernels.split(",")
    if not set(kinds) <= set(KINDS):
        ap.error(f"--kernels: pick from {KINDS}")
    if not torch.cuda.is_available():
        print("kernel_timing: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(tree))
    from luminair_tpu_torch import kernels, tracing
    from luminair_tpu_torch import prelude as T
    from luminair_tpu_torch.models import black_scholes as BS
    from luminair_tpu_torch.pcs import fri

    if Path(kernels.__file__).resolve().parent.parent != tree:
        raise AssertionError(f"imported {kernels.__file__}, not the tree's")
    if hasattr(tracing, "enable"):  # every span ends with a synchronise, as in trees before tracing listened
        tracing.enable()
    card = chip_smoke.phase_card()
    kernels.load_all()
    dev = torch.device("cuda", 0)
    layer_form = hasattr(fri, "fold_layer")
    head = {"tree": str(tree), "card": card, "torch": torch.__version__}

    def emit(line):
        chip_smoke.emit({**head, **line})

    if "T4" in kinds:
        settings_t4(kernels, T, BS, tracing, emit, layer_form)
    if "trace_segment" in kinds:
        trace_segment_variants(kernels, T, BS, tree, emit)
    if "trace_encode" in kinds:
        trace_encode_times(kernels, T, BS, emit, dev)
    if "K6" in kinds:
        tape_times(kernels, emit, dev)
    if "K5" in kinds:
        witness_times(kernels, T, BS, emit)
    if "prove" in kinds:
        prove_times(T, BS, tracing, emit)
    if "air_check" in kinds:
        check_times(kernels, T, BS, emit, dev)
    if "carry" in kinds:
        carry_times(kernels, T, BS, tracing, emit, dev)
    if "logup_sum" in kinds:
        logup_times(kernels, emit, dev)
    if "mesh_devices" in kinds:
        mesh_devices(kernels, T, BS)
    if not {"K3", "K8", "K10", "profiler_window"} & set(kinds):
        return 0
    cx, _ = chip_smoke.pinn_graph(T, BS)
    settings = T.gen_circuit_settings(cx)
    pie = T.gen_trace(cx, settings)
    if "K3" in kinds:
        fri_k3(T, fri, pie, settings, dev, emit, layer_form)
    if "K8" in kinds and hasattr(kernels.CHANNEL, "hosted"):  # the steps' bounds need the latency unit
        chip_smoke.start_probe(kernels)()
        chip_smoke.blake2s_latency(dev)
    if {"K8", "K10"} & set(kinds):
        channel_pow(kernels, T, tracing, pie, settings, emit, kinds)
    if "profiler_window" in kinds:
        profiler_window(kernels, T, pie, settings, dev, emit)
    return 0


if __name__ == "__main__":
    sys.exit(main())
