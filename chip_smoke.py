#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (luminair_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one CUDA card

Phases, one JSON line each; any failure raises and exits non-zero:
  1. the card's name and power limit (nvidia-smi);
  2. build the four kernels from luminair_tpu_torch/csrc (nvcc, sm_90a);
  3. each kernel against its plain PyTorch twin on the card, bit for bit, at
     the shapes the N=256 prove gives it, with CUDA-event times of both and
     the least time the card could take for the same work;
  4. the main path: the 256x256 a*b + a graph through Graph -> compile ->
     gen_circuit_settings -> gen_trace -> prove on the card; every kernel's
     launch counter must grow during the prove, the prover's self-check
     must pass and the native C++ verifier must accept the proof;
  5. one more N=256 prove under torch.profiler: device busy time, idle
     share, and the kernels that take the device's time;
  6. the proof of the 16x16 graph on the card equals, byte for byte, the
     proof made on the CPU.
Then the `kernels` line, and last {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "build", "chip_smoke")

N_MAIN = 256  # the repository's benchmark graph size
N_PARITY = 16
REPS = 7  # timed calls per kernel (median)

# Published H100 SXM peaks (NVIDIA data sheet): 3.35 TB/s of HBM3, and
# 67 TFLOP/s of float32 outside the tensor cores = 132 SMs x 128 FP32 lanes
# x 2 (FMA) x 1.98 GHz.  An SM has 64 INT32 lanes, so the 32-bit integer
# rate is 132 x 64 x 1.98 GHz = a quarter of the float32 figure.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12 / 4

# Integer instructions per field operation, as the kernels compile them:
# a multiply is one 32x32->64 product, the Mersenne fold (and, shift,
# add) and a compare-select; an add or subtract is op, compare, select.
OPS_MUL = 6
OPS_ADD = 3
OPS_QMUL = 16 * OPS_MUL + 14 * OPS_ADD
OPS_QINV = 58 * OPS_MUL + 17 * OPS_ADD  # tower + norm + 38-multiply Fermat chain
OPS_BLAKE2S_BLOCK = 80 * 14 + 16  # 10 rounds x 8 G x 14 ops, final xors


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bound(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(fn, reps: int = REPS) -> float:
    """Median CUDA-event time of one call, after two warm-up calls."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest |a - b| over uint32 words (int32 tensors hold bit patterns)."""
    assert a.shape == b.shape, (a.shape, b.shape)
    ua = a.to(torch.int64) & 0xFFFFFFFF
    ub = b.to(torch.int64) & 0xFFFFFFFF
    return int((ua - ub).abs().max().item()) if a.numel() else 0


def phase_card():
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    print(out, flush=True)
    return out


def phase_build(kernels):
    t0 = time.perf_counter()
    reports = kernels.build()
    kernels.load_all()
    regs = {
        name: [l.split("ptxas info    : ")[-1] for l in rep.splitlines() if "registers" in l]
        for name, rep in reports.items()
    }
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "ptxas": regs})


def phase_kernels(kernels, circle, f, dev):
    """Each kernel against its twin at the N=256 prove's shapes."""
    rng = np.random.default_rng(2024)

    def rnd(*shape):
        return torch.from_numpy(rng.integers(0, f.P, size=shape).astype(np.int32)).to(dev)

    def check(name, kernel_fn, plain_fn):
        a, b = kernel_fn(), plain_fn()
        torch.cuda.synchronize()
        err = max_abs_err(a, b)
        emit({"phase": "kernel_check", "kernel": name, "shape": list(a.shape), "max_abs_err": err})
        if err != 0:
            raise AssertionError(f"{name}: kernel disagrees with its plain version")
        return err

    rows = {}

    # K1: the inputs' iFFT 7 x 2^17 and LDE to 2^18 (B=1; B=2 as well), the
    # composition's forward FFT 4 x 2^18 and its LDE to 2^19.
    v = rnd(7, 1 << 17)
    err = check("circle_fft ifft 7x2^17", lambda: kernels.circle_ifft(v), lambda: kernels.circle_ifft_plain(v))
    err |= check("circle_fft lde B=2 7x2^17", lambda: kernels.circle_lde(v, 2), lambda: kernels.circle_lde_plain(v, 2))
    c4 = rnd(4, 1 << 18)
    err |= check("circle_fft fft 4x2^18", lambda: kernels.circle_fft(c4), lambda: kernels.circle_fft_plain(c4))
    err |= check("circle_fft lde B=1 4x2^18", lambda: kernels.circle_lde(c4, 1), lambda: kernels.circle_lde_plain(c4, 1))
    err |= check("circle_fft lde B=1 7x2^17", lambda: kernels.circle_lde(v, 1), lambda: kernels.circle_lde_plain(v, 1))
    n_in, n_out = 7 << 17, 7 << 18
    stage_ops = 17 * (n_out // 2) * (OPS_MUL + 2 * OPS_ADD)  # stages m = 4 .. 2^18
    rows["circle_fft"] = dict(
        shape="lde B=1, 7 x 2^17 -> 7 x 2^18", err=err,
        ms=time_ms(lambda: kernels.circle_lde(v, 1)),
        plain_ms=time_ms(lambda: kernels.circle_lde_plain(v, 1)),
        bound=bound(4 * (n_in + n_out) + 4 * (1 << 18), stage_ops),
    )

    # K2: the main tree -- 7 leaf columns at 2^18, 31 columns at 2^17 -- and
    # the parent layers above them.
    leaf = rnd(7, 1 << 18)
    mid = rnd(31, 1 << 17)
    err = check("blake2s_merkle leaf 7x2^18", lambda: kernels.merkle_layer(None, leaf),
                lambda: kernels.merkle_layer_plain(None, leaf))
    comp_leaf = rnd(4, 1 << 19)
    err |= check("blake2s_merkle leaf 4x2^19", lambda: kernels.merkle_layer(None, comp_leaf),
                 lambda: kernels.merkle_layer_plain(None, comp_leaf))
    prev = kernels.merkle_layer(None, leaf)
    err |= check("blake2s_merkle 2^17 + 31 cols", lambda: kernels.merkle_layer(prev, mid),
                 lambda: kernels.merkle_layer_plain(prev, mid))
    layer = kernels.merkle_layer(prev, mid)
    for log in range(16, -1, -1):
        cur = layer
        err |= check(f"blake2s_merkle parent 2^{log}", lambda: kernels.merkle_layer(cur, None),
                     lambda: kernels.merkle_layer_plain(cur, None))
        layer = kernels.merkle_layer(cur, None)
    rows["blake2s_merkle"] = dict(
        shape="leaf layer, 7 columns x 2^18", err=err,
        ms=time_ms(lambda: kernels.merkle_layer(None, leaf)),
        plain_ms=time_ms(lambda: kernels.merkle_layer_plain(None, leaf)),
        bound=bound(4 * 7 * (1 << 18) + 32 * (1 << 18), (1 << 18) * (OPS_BLAKE2S_BLOCK + 7)),
    )

    # K3: the composition's circle fold 2^19 -> 2^18, the trace inputs'
    # 2^18 -> 2^17, then a line fold 2^18 -> 2^17 that mixes in the next
    # input (as at line level 17 of the N=256 prove).
    alpha = rng.integers(0, f.P, 4)
    beta2 = rng.integers(0, f.P, 4)
    circ = rnd(1 << 19, 4)
    tw_c = circle.twiddle_stage(19, 0, True, dev)
    err = check("fri_fold circle 2^19", lambda: kernels.fri_fold(circ, tw_c, alpha),
                lambda: kernels.fri_fold_plain(circ, tw_c, alpha))
    circ18 = rnd(1 << 18, 4)
    tw_c18 = circle.twiddle_stage(18, 0, True, dev)
    err |= check("fri_fold circle 2^18", lambda: kernels.fri_fold(circ18, tw_c18, alpha),
                 lambda: kernels.fri_fold_plain(circ18, tw_c18, alpha))
    line = kernels.fri_fold(circ, tw_c, alpha)
    tw_l = circle.twiddle_stage(19, 1, True, dev)
    mix = rnd(1 << 17, 4)
    err |= check("fri_fold line+mix 2^18", lambda: kernels.fri_fold(line, tw_l, alpha, mix, beta2),
                 lambda: kernels.fri_fold_plain(line, tw_l, alpha, mix, beta2))
    fold_ops = (1 << 18) * (8 * OPS_MUL + 8 * OPS_ADD + OPS_QMUL + 4 * OPS_ADD)
    rows["fri_fold"] = dict(
        shape="circle fold 2^19 -> 2^18", err=err,
        ms=time_ms(lambda: kernels.fri_fold(circ, tw_c, alpha)),
        plain_ms=time_ms(lambda: kernels.fri_fold_plain(circ, tw_c, alpha)),
        bound=bound(16 * (1 << 19) + 4 * (1 << 18) + 16 * (1 << 18), fold_ops),
    )

    # K4: the five (commit log, point) groups of the N=256 prove, in its
    # order: (18, z) 12 columns, (17, z) 56, (17, z - G_16) 8, (18, z - G_17)
    # 4, (19, z) 4; the last three add into an earlier group's output.
    err = 0
    groups = {}
    for log, S, acc in ((18, 12, False), (17, 56, False), (17, 8, True), (18, 4, True), (19, 4, False)):
        cols = [rnd(1 << log) for _ in range(S)]
        gam = torch.from_numpy(rng.integers(0, f.P, (S, 4)))
        consts = torch.from_numpy(rng.integers(0, f.P, (5, 4)))
        base = rnd(1 << log, 4) if acc else None
        err |= check(
            f"deep_quotient log {log} S={S}" + (" accumulate" if acc else ""),
            lambda: kernels.deep_quotient(cols, gam, consts, log, base.clone() if acc else None),
            lambda: kernels.deep_quotient_plain(cols, gam, consts, log, base),
        )
        groups[(log, S)] = (cols, gam, consts)
    S, log = 56, 17
    cols, gam, consts = groups[(log, S)]
    row_ops = (8 + 4 * S + 4) * OPS_MUL + (8 + 4 * S + 8) * OPS_ADD + OPS_QINV + OPS_QMUL
    rows["deep_quotient"] = dict(
        shape="log 17, S = 56", err=err,
        ms=time_ms(lambda: kernels.deep_quotient(cols, gam, consts, log)),
        plain_ms=time_ms(lambda: kernels.deep_quotient_plain(cols, gam, consts, log)),
        bound=bound(4 * S * (1 << log) + 8 * (1 << log) + 16 * (1 << log), (1 << log) * row_ops),
    )
    for name, r in rows.items():
        emit({"phase": "kernel_time", "kernel": name, "shape": r["shape"], "ms": r["ms"],
              "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0], "bound_by": r["bound"][1]})
    return rows


def bench_graph(T, n: int):
    cx = T.Graph()
    rng = np.random.default_rng(0)
    a = cx.tensor((n, n)).set(rng.normal(size=(n, n)))
    b = cx.tensor((n, n)).set(rng.normal(size=(n, n)))
    (a * b + a).retrieve()
    cx.compile()
    settings = T.gen_circuit_settings(cx)
    pie = T.gen_trace(cx, settings)
    return pie, settings


def phase_main(T, kernels, serde, tracing, card):
    t0 = time.perf_counter()
    pie, settings = bench_graph(T, N_MAIN)
    trace_s = time.perf_counter() - t0
    cells = sum(t.n_rows * len(t.columns) for t in pie.trace_tables.values() if t.n_rows)
    emit({"phase": "trace", "n": N_MAIN, "trace_cells": cells, "host_seconds": trace_s,
          "tables": {k: [t.log_size, len(t.columns)] for k, t in pie.trace_tables.items()}})

    kernels.reset_counts()
    t0 = time.perf_counter()
    proof = T.prove(pie, settings)  # the main path: one prove on the card
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = kernels.counts()
    emit({"phase": "main_path", "first_prove_seconds": first_s, "launches": launches})
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"the prove launched no {missing}")

    times, phases = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        again = T.prove(pie, settings)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        phases.append(tracing.last_phases("prove"))
    med = statistics.median(times)
    pb = serde.proof_to_flat_bytes(proof)
    if serde.proof_to_flat_bytes(again) != pb:
        raise AssertionError("repeated proves of one PIE differ")

    os.makedirs(OUT_DIR, exist_ok=True)
    proof_path = os.path.join(OUT_DIR, f"proof_{N_MAIN}.lmv")
    settings_path = os.path.join(OUT_DIR, f"settings_{N_MAIN}.lms")
    with open(proof_path, "wb") as fh:
        fh.write(pb)
    with open(settings_path, "wb") as fh:
        fh.write(serde.settings_to_flat_bytes(settings))
    subprocess.run(["make", "-C", os.path.join(ROOT, "native")], check=True,
                   capture_output=True, text=True, timeout=600)
    t0 = time.perf_counter()
    res = subprocess.run([os.path.join(ROOT, "native", "build", "luminair-verify"), proof_path,
                          settings_path], capture_output=True, text=True, timeout=600)
    verify_s = time.perf_counter() - t0
    if res.returncode != 0:
        raise AssertionError(f"native verifier rejected the proof: {res.stdout}{res.stderr}")
    emit({
        "phase": "prove", "n": N_MAIN, "card": card, "prove_seconds": times,
        "prove_seconds_median": med, "trace_cells_per_s": cells / med,
        "phases_s": phases[times.index(med)], "proof_bytes": len(pb),
        "self_check": "passed", "native_verify": "accepted", "native_verify_seconds": verify_s,
    })
    return launches, pie, settings


def phase_profile(T, pie, settings):
    """One prove under torch.profiler: the device's busy time (the sum of
    kernel times; one stream, so kernels do not overlap), its idle share of
    the profiled wall time, and the kernels that take the most device time
    (the profiler's own cost lengthens the wall time, so the idle share is
    an upper estimate)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        T.prove(pie, settings)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        # Kernel entries only: an operator's entry repeats its kernels' time.
        if str(getattr(e, "device_type", "CPU")).endswith("CPU"):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            rows.append((e.key, us / 1e3, e.count))
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    emit({
        "phase": "profile", "n": N_MAIN, "wall_ms_profiled": wall_ms,
        "device_busy_ms": busy_ms if rows else "not measured",
        "device_idle_share": 1 - busy_ms / wall_ms if rows else "not measured",
        "device_kernels": len(rows),
        "port_kernels": {
            name: {"ms": sum(ms for k, ms, _ in rows if name in k),
                   "count": sum(c for k, _, c in rows if name in k)}
            for name in ("fft_stage_kernel", "fft_embed_kernel", "merkle_layer_kernel",
                         "fri_fold_kernel", "deep_quotient_kernel")
        },
        "top": [{"name": k[:90], "ms": ms, "count": c} for k, ms, c in rows[:15]],
    })


def phase_parity(T, serde):
    pie, settings = bench_graph(T, N_PARITY)
    gpu = serde.proof_to_flat_bytes(T.prove(pie, settings, device="cuda"))
    cpu = serde.proof_to_flat_bytes(T.prove(pie, settings, device="cpu"))
    if gpu != cpu:
        raise AssertionError(f"N={N_PARITY}: GPU proof bytes differ from CPU proof bytes")
    emit({"phase": "gpu_vs_cpu", "n": N_PARITY, "proof_bytes": len(gpu), "equal": True})


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from luminair_tpu_torch import fields as f
    from luminair_tpu_torch import circle, kernels, serde, tracing
    from luminair_tpu_torch import prelude as T

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = phase_card()
    phase_build(kernels)
    rows = phase_kernels(kernels, circle, f, dev)
    launches, pie, settings = phase_main(T, kernels, serde, tracing, card)
    phase_profile(T, pie, settings)
    phase_parity(T, serde)

    line = []
    for k in kernels.KERNELS:
        r = rows[k.name]
        line.append({
            "name": k.name, "route": "cuda", "source": f"luminair_tpu_torch/csrc/{k.source}",
            "replaces": k.replaces, "launches": launches[k.name], "max_abs_err": r["err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
            "bound_by": r["bound"][1], "library_ms": None,
        })
    emit({"kernels": line})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
