#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (luminair_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one CUDA card

Phases, one JSON line each; any failure raises and exits non-zero:
  1. the card's name and power limit (nvidia-smi);
  2. build the sixteen kernels from luminair_tpu_torch/csrc (nvcc,
     sm_90a, one process per source, all at once), with ptxas' register
     and spill report;
  3. the black-scholes PINN's settings and trace on the host interpreter
     (batch 256), timed;
  4. K1-K7 against their plain PyTorch twins on the card, bit for bit:
     K1 on both sides of its tile and group-pass sizes and at 2^23, K1-K3
     at the shapes the N=256 prove gives them, K4 on groups whose
     constants come from sample points (the N=256 prove's five groups in
     one call, three points at one log, a line through a domain row, logs
     below a CTA), K2 on whole trees at the sides of its tile (2^10 nodes),
     K5/K6 and the check (air_check) on the tape of every PINN component
     at its batch-256 trace and commit sizes, K7 at the PINN's OODS groups, alone and in one call,
     and at groups below and above a chunk, K3's layer launch at the N=256
     prove's shapes and at the PINN's 2^23 circle fold and first committed
     layer, K8's step in K2's root pass on random channel states (FRI
     layers' trees of one and of several passes) against the plain tree and
     step, K9 on a pass over trees of the PINN's sizes and on one whose
     position lists exceed shared memory, K10 at 0, 5, 12 and 16 bits and
     on a digest whose first passing nonce lies beyond the first round
     (each call one launch, no fill, no upload, one download: profiled);
     the latency of one dependent Blake2s compression on one thread (K8's
     bound) and of one compression's 240 dependent operations written out
     apart (its floor; both probes in tools/blake2s_latency.cu, built
     beside the kernels); the rate of the M31 and QM31 arithmetic on the
     whole card (tools/field_rate.cu, built beside them too; K5's and
     K6's operation rate where above the two pipes' issue ceiling);
     CUDA-event times of kernel and twin and the least time the card
     could take for the same work;
  5. the bench path: the 256x256 a*b + a graph through Graph -> compile ->
     gen_circuit_settings -> gen_trace -> prove, all on the card by
     default; every kernel of the path must launch between the counters'
     reset and the first prove's end; the card's settings and PIE must
     equal the host interpreter's (downloaded after the timed window);
     card and host seconds of settings and trace, with the sub-spans of
     the two passes (graph/device_trace.py); trace_segment launched once
     per segment (at most one more than the pass's T3 launches, and in
     the settings pass its T4 launches); the prover's self-check
     must pass, the host PIE's proof must have the same bytes, and the
     native C++ verifier must accept the proof; K2 may take at most
     ceil((L + 1) / (t + 1)) launches per tree of 2^L leaves (tile 2^t),
     K4 and K7 one call per prove, K3 one launch per committed FRI layer
     and one for the largest input's circle fold (8 at N=256, 10 at the
     PINN), K8 one launch per prove (alpha0; each committed layer's step
     runs in its tree's root pass, counted apart) and K10 one; then the
     path once more keeping the
     inputs of each kernel call at each distinct shape (the trace
     segments and T3 steps too), every kept call run again through the
     kernel and through its plain twin, bit for bit (a segment three
     times, from fresh outputs each time, and each of its nodes alone as
     a one-node segment), and the bounds of every kernel's calls summed
     (per_run_bound; the settings pass's apart, and trace_segment's also
     over its nodes alone); then one prove, one
     settings pre-pass and one trace under torch.profiler (each window
     padded: Profiled): device busy time, idle share, copies, and
     the kernels that take the device's time; K8's device time per prove
     (alpha0's launch and each FRI layer's step, its root pass with the
     step less without) and K2's less those steps, each against its
     per-prove bound;
  6. the PINN path: the 2-64-64-1 network (Linear + tanh, random weights
     from a seed) at batch 256 through Graph -> nn.Linear -> compile ->
     gen_circuit_settings -> gen_trace -> prove, the same checks, the
     model's output within 0.05 of its float64 forward pass,
     trace_segment, T3 and T4 timed at the largest call each made (and
     every segment of the path alone), and profiles of the prove, the
     settings pre-pass and the trace;
  6b. the PINN at the 80-bit profile (path pinn_b256_hs): the same card PIE
     and settings proved with PcsConfig.high_security() (16 PoW bits, 64
     queries): launches of one prove with the counters reset just before,
     the median of 3 proves, the host PIE's proof the same bytes, the
     native verifier accepting the proof and rejecting it with its nonce
     plus one, every kernel call of one prove replayed through kernel and
     twin, K8-K10 timed at the calls this prove made (K8's step as its
     root pass with and without it), one profiled prove;
  6c. after each path's prove (bench_n256, pinn_b256, pinn_b256_hs) and
     for all_ops, the verify path: the port's verify on the card (the 80-bit
     proof held to its profile and 80 bits) with every launch counter set to
     0 just before the first verify (the preprocessed root's cache cold) and
     read just after, every plain twin refused: it must accept, launch K1
     and K2 and nothing else, and recommit the proof's tree-0 root; the
     median of 3 warm verifies with the spans; the port and native/ (the
     port's ctypes binding) rejecting the proof with its nonce plus one, a
     byte of a main-tree opened value flipped and a byte of the preprocessed
     root flipped; the proof's .npz and JSON files, the settings' JSON and
     binary files and the card PIE's file (proved again on the card) giving
     the path's bytes back; the recommit's K1 and K2 calls replayed through
     kernel and twin; one profiled cold verify (the `verify` line);
  6d. the PINN's card PIE proved at log blowup 2 (path pinn_b256_b2: commit
     domains up to 2^23): launches of the first prove, the median of 3, the
     host PIE's proof the same bytes, native/ accepting it, peak device
     memory beside blowup 1's;
  6e. check_pie_constraints (air/debug.py) on the PINN's card PIE (phase
     debug): empty, K5 and air_check the only launches of the first call
     (counters reset just before it, read just after), air_check exactly
     once (every component in one launch), its seconds cold and warm;
     mul.out changed at row 3 names constraint 1 of mul at row 3 alone;
     every air_check call of a run through kernel and twin; the PINN's
     whole check launch timed beside its twin and bound;
  7. the six op graphs (models/op_graphs.py): the card's settings and PIE
     against the host interpreter's, each trace segment and step through
     kernel and twin, and all_ops proved on the card and accepted by the native
     verifier (then its verify path, 6c); then every op graph proved from
     its card PIE at log blowups 1-4 (phase op_graph_blowup): the same bytes
     as the card's proof of the host PIE and (but for all_ops and mlp at 3-4)
     as the port's CPU proof, accepted by the port's verify and native/;
     check_pie_constraints on every op graph's card PIE (empty) and on
     twelve card PIEs with one cell changed, each the same dict as the
     port's check on the CPU, every air_check call through kernel and twin;
     then air_check_many over all 18 compiled components in one launch, on
     random words and on small words with their honest interaction, at
     the op graphs' row counts and at the PINN's, each bit for bit against
     its twin (random words set every constraint's bit in the twin);
  7b. the three port examples (examples/torch_*.py), each main() on the
     card (phase example): its printed lines, seconds and launches; each
     passes its own assertions, and examples/out/ keeps its bytes;
  8. the 16x16 graph traced and proved on the card equals, byte for byte,
     the same traced and proved on the CPU, at the default profile and at
     high_security();
  9. several devices (luminair_tpu_torch/parallel/sharding.py): logup_sum
     against its twin at prover_step's two shapes (2 relation columns of
     8 x 2^5 and of 16 x 2^21, the PINN's `mul` width and rows), timed at
     the larger beside its twin and bound (with the kernel checks of 4);
     then through a plan built once, as prover_step calls it (phase
     logup_plan): the planned call at both shapes against the twin, one
     plan on four quarters of the full-width rows in turns with a second
     plan of another z and alpha, each call against the twin, the planned
     call timed (the kernels line's ms), and the lead's adds of a 4-shard
     prover_step's LogUp part counted in the host's profiler records
     (gated to 1);
     after each of bench_n256's and pinn_b256's verify, the path's card
     PIE proved under prove_mesh over 2 and 4 shards of the card (phase
     mesh_prove: counters set to 0 and every twin refused just before the
     first prove, the one-device proof's bytes, native/ accepting them, 3
     timed proves beside 3 one-device ones, the bytes gathered onto the
     lead -- gated at or below the sharding docstring's formula -- moved
     between shards and scattered from the lead, K1-K7 and K9 launches per
     shard, peak memory (each card's on distinct cards); every row shard
     must launch K1-K6, and each but the first K5's carry pass,
     add_carry, exactly once a prove: every component's block in one
     launch; shard 0 none; in the host's records of one more profiled
     prove one cumsum and one carry copy a shard after the first), and
     over the distinct cards where there are two or more (else a mesh_devices line: "ran": false); after the
     PINN's, K3-K6 in their row-shard modes at the PINN's shapes (phase
     mesh_kernels): its card PIE proved over 4 shards of the card at log
     blowups 1 and 2 with every call of K3-K6 and the carry pass kept,
     each kept call then through kernel and twin on the same inputs, bit
     for bit (K5 on a row block with its carry, K6 on a row block with its
     row offset and halo at strides 2 and 4, K4's plan of a row shard, K3
     on a mirror-assembled block), the carry pass and K6 on its largest
     block timed; at the end
     prover_step at both shapes over 1, 2 and 4 shards and a 2 x 2
     ('rows', 'cols') mesh of the card (phase mesh_step: each first call's
     launches equal to sharding.step_launches -- the kernels line's
     logup_sum launches are the full-width 4-shard call's -- results equal
     to the one-shard call's and the twins', the reshard's bytes against
     (n - 1)/n of the tree's, 3 timed calls), and dryrun_multichip(4)
     (luminair_tpu_torch/graft_entry.py; its line says whether the mesh was
     virtual);
 10. the training script, examples/model/torch_train_black_scholes.py
     (phase train): 3000 Adam steps of the PINN on the card, its weights
     written to a temporary directory, the wall time; the last loss below
     a tenth of the first, every weight finite in load_weights()' shapes,
     examples/model/weights.npz untouched; 50 steps on the card and on the
     CPU from the same seed, the losses within rtol 1e-3.
Then the `kernels` line, and last {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import inspect
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
PINN_BATCH = 256  # the flagship's recorded batch
REPS = 7  # timed calls per kernel (median)

# Published H100 SXM peaks (NVIDIA data sheet): 3.35 TB/s of HBM3, and
# 67 TFLOP/s of float32 outside the tensor cores = 132 SMs x 128 FP32 lanes
# x 2 (FMA) x 1.98 GHz.  An SM has 64 INT32 lanes, so the 32-bit integer
# rate is 132 x 64 x 1.98 GHz = a quarter of the float32 figure.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12 / 4
# An SM's 4 schedulers each issue one warp instruction a cycle, 128 lane
# operations, whichever pipe takes them: the field arithmetic's products
# go to the FMA pipe as IMAD (64 lanes) beside the ALU's adds, compares
# and selects (64 lanes), so its ceiling is both pipes at once.  K5's and
# K6's bounds use it, or tools/field_rate.cu's measured rate where that
# is higher (field_ops_per_s).
INT32_ISSUE_OPS_PER_S = 2 * INT32_OPS_PER_S

# Integer instructions per field operation, as the kernels compile them:
# a multiply is one 32x32->64 product, the Mersenne fold (and, shift,
# add) and a compare-select; an add or subtract is op, compare, select.
OPS_MUL = 6
OPS_ADD = 3
OPS_QMUL = 16 * OPS_MUL + 14 * OPS_ADD
OPS_QINV = 58 * OPS_MUL + 17 * OPS_ADD  # tower + norm + 38-multiply Fermat chain
OPS_INV = 38 * OPS_MUL
OPS_BLAKE2S_BLOCK = 80 * 12 + 8  # 10 rounds x 8 G x 12 ops, one LOP3 per output word
# (a G: 4 IADD3 that add three words, 4 XOR, 2 PRMT for the 16- and 8-bit
# rotations, 2 SHF for the 12- and 7-bit ones; tools/blake2s_sass_ops.py
# counts them in the SASS of csrc/blake2s.cuh's compression)
# What one proof-of-work candidate needs (K10): the compression less round
# 0's seven G's that read no nonce word (its column step and three G's of
# its diagonal step), less the 6 output words the check never reads and
# round 9's diagonal work that neither read word depends on (the last b
# rotation of two G's, 2 ops each, and everything after a's second update
# in the other two, 5 each): 864.  The SASS of csrc/channel.cuh's pow_h01
# does one candidate in 856 ALU instructions (tools/blake2s_sass_ops.py,
# sm_90a), so the bound charges the smaller count, as K2's charges 968
# against the SASS's 970.
OPS_POW_CANDIDATE = min(OPS_BLAKE2S_BLOCK - 7 * 12 - 6 - (2 * 2 + 2 * 5), 856)
OPS_DENOM = 4 * OPS_MUL + 8 * OPS_ADD  # v0 + alpha * v1 - z
# A product added to a 64-bit sum with one fold (K7): the 32x32->64
# product, the fold's and, shift and add, the 64-bit add (two).
OPS_FOLD_MAC = 6
# A product added to a 64-bit sum that is folded only once per four products
# (four products of words below 2^31 fit it): one 32x32+64 multiply-add,
# counted as two operations; the fold (and, shift, add) apart (K4's bound).
OPS_MAC64 = 2
OPS_FOLD = 3

def fft_work(words_in: int, words_out: int, log_n: int, n_stages: int, inverse: bool):
    """(bytes, operations) of one K1 call: its input read and output written
    once, the 2^log_n-word twiddle table read once; per stage a butterfly
    per pair of output words (inverse: two products, a sum and a
    difference; forward: one product, a sum and a difference)."""
    per_pair = 2 * OPS_MUL + 2 * OPS_ADD if inverse else OPS_MUL + 2 * OPS_ADD
    return 4 * (words_in + words_out) + 4 * (1 << log_n), n_stages * (words_out // 2) * per_pair


PORT_KERNEL_NAMES = (
    "fft_pass_kernel", "merkle_pass_kernel", "fri_layer_kernel",
    "deep_quotient_kernel", "air_witness_kernel", "air_domain_kernel",
    "oods_partial_kernel", "oods_combine_kernel", "channel_draw_kernel",
    "decommit_kernel", "grind_pow_kernel", "trace_segment_kernel", "trace_reduce_kernel",
    "lut_boundary_kernel", "check_tapes_kernel",
)


def tape_ops(tp) -> int:
    """Integer operations of one row's tape arithmetic."""
    from luminair_tpu_torch.air import tape

    cost = {tape.OP_ADD: OPS_ADD, tape.OP_SUB: OPS_ADD, tape.OP_NEG: OPS_ADD, tape.OP_MUL: OPS_MUL}
    return sum(cost.get(ins[0], 0) for ins in tp.instructions())


# A QM31 inverse less its M31 inversion: the CM31 norm of each half (two
# CM31 squares), the norm's M31 norm, and the conjugate's products.
OPS_QINV_NORMS = OPS_QINV - OPS_INV
# A row's entries inverted together: the M31 norms' prefix products and the
# products back, 3 (E - 1), and one M31 inversion for all of them; 1 in
# place of a zero norm (nonzero and an add) per entry.
OPS_BATCH_MASK = 4


def witness_row_ops(tp, batched: bool = True) -> int:
    """K5 per trace row: the tape, per entry a denominator, its inverse, a
    product by the multiplicity and a sum; the running sum's 4 adds.  The
    inverses batched (csrc/air.cuh, PR 17): per entry the norms and
    conjugate products, one M31 inversion a row and 3 (E - 1) products;
    unbatched (the count before): a whole QM31 inverse per entry."""
    E = tp.n_relations
    per = OPS_DENOM + 4 * OPS_MUL + 4 * OPS_ADD
    if batched:
        inverses = E * (OPS_QINV_NORMS + OPS_BATCH_MASK) + 3 * (E - 1) * OPS_MUL + OPS_INV
    else:
        inverses = E * OPS_QINV
    return tape_ops(tp) + E * per + inverses + 4 * OPS_ADD


def domain_term_ops(tp) -> int:
    """K6 per commit row and component: the tape, a QM31-by-M31 product
    and a sum per constraint, per entry a denominator, two QM31 products
    and the differences, the last entry's previous row and claimed sum."""
    return (
        tape_ops(tp)
        + tp.n_constraints * (4 * OPS_MUL + 4 * OPS_ADD)
        + tp.n_relations * (OPS_DENOM + 2 * OPS_QMUL + 16 * OPS_ADD)
        + 8 * OPS_ADD + 4 * OPS_MUL
    )


def vanishing_ops(log_trace: int) -> int:
    """K6 per commit row, once for all the components of a domain: V_n's
    squarings, its inverse and the product by it."""
    return (log_trace - 1) * (OPS_MUL + 2 * OPS_ADD) + OPS_INV + 4 * OPS_MUL


def check_row_ops(tp) -> int:
    """air_check per trace row: the tape, a compare per recorded constraint,
    per entry a denominator, a QM31 product, the differences and a compare
    of four coordinates; the last entry's previous row and is_first times
    the claimed sum."""
    return (
        tape_ops(tp) + tp.n_constraints
        + tp.n_relations * (OPS_DENOM + OPS_QMUL + 8 * OPS_ADD + 4)
        + 8 * OPS_ADD + 4 * OPS_MUL
    )


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bound(n_bytes: float, n_ops: float, ops_per_s: float = INT32_OPS_PER_S):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
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


# Idle host time inside a profiled window before its calls and after they
# end; the warm-up launches at its start, each of a kernel that spins for
# about 0.1 ms; the windows tried before a record that must be there is
# taken as missing (Profiled).
PROFILE_PAD_S = 0.01
PROFILE_WARM_UP_LAUNCHES = 8
PROFILE_WARM_UP_CYCLES = 200_000
PROFILE_TRIES = 3
# The host's records of the CUDA runtime and driver calls that put work on
# the card: kernel launches, copies, fills of memory.
HOST_LAUNCH = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx")
HOST_COPY = ("cudaMemcpy", "cuMemcpy")
HOST_MEMSET = ("cudaMemset", "cuMemset")


class Profiled:
    """`run` under torch.profiler (host and device activity).  The window
    opens with a warm-up, PROFILE_WARM_UP_LAUNCHES launches of
    torch.cuda._sleep's kernel, awaited, then PROFILE_PAD_S; `run` follows,
    and the window closes PROFILE_PAD_S after it has ended on the card.
    With `need`, a window in which no device record's name holds `need` is
    run again, PROFILE_TRIES windows at most.  Fields: `device`, {device
    record name: [ms, count]}; `host`, the counts of the host's records of
    kernel launches, copies and memory fills (one a runtime or driver
    call); `ops`, the host's records of aten operators, (name, input
    shapes, input dtypes, scalar inputs) each, the last three empty but
    with `record_shapes`; `lost`, (position among those calls in the
    window's order, call name) of each call whose correlation id has no
    device record;
    `device_lead_us`, the most by which a device record starts before its
    call's host record; `warm_up_recorded`, how many warm-up launches have
    a device record; `tries`; `wall_ms`, `run` and a synchronise.  The
    warm-up is left out of all but `warm_up_recorded`.

    Why: once chip_smoke.py's paths had run, the profiler lost device
    records at the start of most windows (the first one to six calls'), and
    once all 100 launches of a window, while the host's records held every
    call (PERF.md).  The device's records did not start early
    (`device_lead_us` about -5 us), so a window's lead time does not help;
    a warm-up does, mostly.  So a count of work reads the host's records,
    and the device's records name and time that work."""

    def __init__(self, run, need: str = "", record_shapes: bool = False):
        for self.tries in range(1, PROFILE_TRIES + 1):
            self._window(run, record_shapes)
            if not need or self.count(need):
                break

    def _window(self, run, record_shapes: bool):
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], record_shapes=record_shapes) as prof:
            for _ in range(PROFILE_WARM_UP_LAUNCHES):
                torch.cuda._sleep(PROFILE_WARM_UP_CYCLES)
            torch.cuda.synchronize()
            time.sleep(PROFILE_PAD_S)
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            self.wall_ms = (time.perf_counter() - t0) * 1e3
            time.sleep(PROFILE_PAD_S)
        on_card, calls, self.ops = [], [], []
        for e in prof.profiler.kineto_results.events():
            name = e.name()
            if e.device_type() != DeviceType.CPU:
                dur = e.duration_ns() / 1e6 if hasattr(e, "duration_ns") else e.duration_us() / 1e3
                on_card.append((e.correlation_id(), name, dur, e.start_ns()))
            elif name in HOST_LAUNCH or name.startswith(HOST_COPY + HOST_MEMSET):
                calls.append((e.start_ns(), e.correlation_id(), name))
            elif name.startswith("aten::"):
                self.ops.append((name, e.shapes(), e.dtypes(), e.concrete_inputs()) if record_shapes
                                else (name, [], [], []))
        calls.sort()
        warm_up = {c for _, c, name in calls[:PROFILE_WARM_UP_LAUNCHES] if name in HOST_LAUNCH}
        if len(warm_up) != PROFILE_WARM_UP_LAUNCHES:
            raise AssertionError("Profiled: the window holds no record of its warm-up launches")
        calls = calls[PROFILE_WARM_UP_LAUNCHES:]
        self.warm_up_recorded = sum(1 for c, *_ in on_card if c in warm_up)
        self.device, starts = {}, {}
        for c, name, dur, start in on_card:
            if c not in warm_up:
                ms, n = self.device.get(name, (0.0, 0))
                self.device[name] = [ms + dur, n + 1]
                starts[c] = start
        self.host = {"launches": sum(1 for *_, n in calls if n in HOST_LAUNCH),
                     "copies": sum(1 for *_, n in calls if n.startswith(HOST_COPY)),
                     "memsets": sum(1 for *_, n in calls if n.startswith(HOST_MEMSET))}
        self.lost = [(i, name) for i, (_, c, name) in enumerate(calls) if c not in starts]
        leads = [(t - starts[c]) / 1e3 for t, c, _ in calls if c in starts]
        self.device_lead_us = max(leads) if leads else None

    def count(self, part: str) -> int:
        return sum(n for k, (_, n) in self.device.items() if part in k)

    def op_count(self, *names: str) -> int:
        return sum(1 for op in self.ops if op[0] in names)

    def ms(self, part: str) -> float:
        return sum(ms for k, (ms, _) in self.device.items() if part in k)


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


PROBE_SOURCES = {  # the probes' sources and the symbols each exports
    "blake2s_latency": ("lum_blake2s_chain", "lum_blake2s_critical_path"),
    "field_rate": ("lum_field_rate",),
}
PROBE = {}  # the probes' functions (phase_build)


def start_probe(kernels):
    """Start nvcc on each of tools/blake2s_latency.cu (the latency probes)
    and tools/field_rate.cu (the field arithmetic's rate), with the
    kernels' flags and csrc/ headers, all at once; returns the function
    that waits for them and loads their functions into PROBE."""
    import ctypes

    os.makedirs(OUT_DIR, exist_ok=True)
    procs = {}
    for name in PROBE_SOURCES:
        lib = os.path.join(OUT_DIR, name + ".so")
        procs[name] = lib, subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-I", str(kernels._CSRC), "-o", lib,
             os.path.join(ROOT, "tools", name + ".cu")], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def finish():
        for name, (path, proc) in procs.items():
            out, err = proc.communicate()
            if proc.returncode != 0:
                raise AssertionError(f"tools/{name}.cu did not build:\n{err}{out}")
            lib = ctypes.CDLL(path)
            for sym in PROBE_SOURCES[name]:
                PROBE[sym] = getattr(lib, sym)
                PROBE[sym].restype = ctypes.c_int
        for sym in PROBE_SOURCES["blake2s_latency"]:
            PROBE[sym].argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p]
        PROBE["lum_field_rate"].argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                                            ctypes.c_int, ctypes.c_void_p]

    return finish


def phase_build(kernels):
    """The kernels, and beside them the latency probes (start_probe)."""
    t0 = time.perf_counter()
    probe_done = start_probe(kernels)
    reports = kernels.build()
    kernels.load_all()
    probe_done()
    regs = {
        name: [l.split("ptxas info    : ")[-1].strip() for l in rep.splitlines() if "registers" in l or "spill" in l]
        for name, rep in reports.items()
    }
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "ptxas": regs})


def tree_words(kernels, cols_by_log, run) -> torch.Tensor:
    """Every digest of a new tree over `cols_by_log`, hashed by `run` (K2 or
    its twin), layers bottom to root."""
    bottom = max(cols_by_log)
    desc = kernels.TreeDesc(kernels.tree_layers(bottom, cols_by_log[bottom].device), cols_by_log)
    run(desc)
    return torch.cat([desc.layers[log] for log in range(bottom, -1, -1)])


def phase_kernels(kernels, circle, f, dev, pinn_logs):
    """Each kernel against its twin: K1-K4 at the N=256 prove's shapes,
    K5-K7 at the PINN's."""
    from luminair_tpu_torch.crypto.merkle import MerkleTree

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

    # K1 on both sides of its tile (2^12 rows), of one group pass (2^20)
    # and of two tiles' logs (2^24), and at 2^23, the composition's size:
    # ifft, fft and the LDE at blowups 1..4 (one column from 2^20 up, 3
    # below; from 2^24 up blowup 1, which keeps the largest transform at
    # 2^27 rows and its host-built twiddle table a few GB).
    err = 0
    for log in (12, 13, 20, 21, 23, 24, 25):
        x = rnd(1 if log >= 20 else 3, 1 << log)
        err |= check(f"circle_fft ifft {tuple(x.shape)}", lambda: kernels.circle_ifft(x), lambda: kernels.circle_ifft_plain(x))
        err |= check(f"circle_fft fft {tuple(x.shape)}", lambda: kernels.circle_fft(x), lambda: kernels.circle_fft_plain(x))
        for b in (1, 2, 3, 4) if log < 24 else (1,):
            err |= check(f"circle_fft lde B={b} {tuple(x.shape)}", lambda: kernels.circle_lde(x, b),
                         lambda: kernels.circle_lde_plain(x, b))
        del x
    circle.twiddle_table.cache_clear()  # the tables of these sizes stay out of the paths' peak memory
    torch.cuda.empty_cache()
    # The N=256 prove's: the inputs' iFFT 7 x 2^17 and LDE to 2^18 (B=1;
    # B=2 as well), the composition's forward FFT 4 x 2^18 and its LDE.
    v = rnd(7, 1 << 17)
    err |= check("circle_fft ifft 7x2^17", lambda: kernels.circle_ifft(v), lambda: kernels.circle_ifft_plain(v))
    err |= check("circle_fft lde B=2 7x2^17", lambda: kernels.circle_lde(v, 2), lambda: kernels.circle_lde_plain(v, 2))
    c4 = rnd(4, 1 << 18)
    err |= check("circle_fft fft 4x2^18", lambda: kernels.circle_fft(c4), lambda: kernels.circle_fft_plain(c4))
    err |= check("circle_fft lde B=1 4x2^18", lambda: kernels.circle_lde(c4, 1), lambda: kernels.circle_lde_plain(c4, 1))
    err |= check("circle_fft lde B=1 7x2^17", lambda: kernels.circle_lde(v, 1), lambda: kernels.circle_lde_plain(v, 1))
    rows["circle_fft"] = dict(
        shape="lde B=1, 7 x 2^17 -> 7 x 2^18", err=err,
        ms=time_ms(lambda: kernels.circle_lde(v, 1)),
        plain_ms=time_ms(lambda: kernels.circle_lde_plain(v, 1)),
        bound=bound(*fft_work(v.numel(), 7 << 18, 18, 17, False)),
    )

    # K2: whole trees against the twin -- the N=256 main tree (7 columns at
    # 2^18, 31 at 2^17; timed), the composition's 4 x 2^19, bottom logs at
    # t - 1, t, t + 1 and 2t + 1 of the tile (t = 10), one leaf, and a FRI
    # layer's transposed view.
    leaf, mid = rnd(7, 1 << 18), rnd(31, 1 << 17)
    main_tree = {18: leaf, 17: mid}
    t = kernels.MERKLE_TILE_LOG
    err = 0
    for name, cols in (("main 7x2^18 + 31x2^17", main_tree), ("composition 4x2^19", {19: rnd(4, 1 << 19)}),
                       (f"2^{t - 1} + 3x2^4", {t - 1: rnd(2, 1 << (t - 1)), 4: rnd(3, 16)}),
                       (f"2^{t} + 31x2^{t - 1}", {t: rnd(7, 1 << t), t - 1: rnd(31, 1 << (t - 1))}),
                       (f"2^{t + 1} + 40x2^{t} + 2^0", {t + 1: rnd(2, 1 << (t + 1)), t: rnd(40, 1 << t), 0: rnd(1, 1)}),
                       (f"2^{2 * t + 1} + 3x2^{t + 6}",
                        {2 * t + 1: rnd(1, 1 << (2 * t + 1)), t + 6: rnd(3, 1 << (t + 6))}),
                       ("one leaf", {0: rnd(3, 1)}), ("FRI layer 2^16 x 4", {16: rnd(1 << 16, 4).t()})):
        err |= check(f"blake2s_merkle tree {name}", lambda: tree_words(kernels, cols, kernels.merkle_tree),
                     lambda: tree_words(kernels, cols, kernels.merkle_tree_plain))
    tree_bound = bound(*merkle_tree_work(main_tree))
    rows["blake2s_merkle"] = dict(
        shape="whole tree, 7 columns x 2^18 + 31 columns x 2^17", err=err,
        ms=time_ms(lambda: MerkleTree(main_tree)),
        plain_ms=time_ms(lambda: tree_words(kernels, main_tree, kernels.merkle_tree_plain)), bound=tree_bound,
    )

    rows["fri_layer"] = fri_layer_kernel(kernels, circle, dev, rnd, check)
    rows["deep_quotient"] = quotient_kernel(kernels, circle, dev, rng, rnd, check)
    transcript_kernels(kernels, f, dev, rng, rnd, check)
    rows.update(tape_kernels(kernels, f, dev, pinn_logs, rng, rnd, check))
    rows.update(oods_kernel(kernels, circle, f, dev, rng, rnd, check))
    circle.twiddle_table.cache_clear()  # the checks' tables (K3's of logs 22 and 17) stay out of the paths' peaks
    for name, r in rows.items():
        emit({"phase": "kernel_time", "kernel": name, "shape": r["shape"], "ms": r["ms"],
              "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
              **{f"{k}_ms": r[k][0] for k in ("bound_alu", "bound_before") if k in r}})
    return rows


def fri_layer_kernel(kernels, circle, dev, rnd, check) -> dict:
    """K3 against its twin: the N=256 prove's circle fold 2^19 -> 2^18 and its
    first committed layer (line log 18, two folds, the inputs of circle
    logs 18 and 17 joining), a three-fold layer with an input joining at
    its last fold, and the PINN's 2^23 circle fold and first committed
    layer (line log 22, two folds, the input of circle log 22 joining at
    fold 0; timed).  The challenges lie on the card, as K8 draws them."""
    alpha0, alpha = rnd(4), rnd(4)

    def layer(kmax, L, folds, joins):
        tws = [circle.twiddle_stage(kmax, kmax - (L - t), True, dev) for t in range(folds)]
        mixes = [(rnd(1 << (L - t), 4), circle.twiddle_stage(L - t, 0, True, dev)) if L - t in joins else None
                 for t in range(folds)]
        return rnd(1 << L, 4), tws, alpha, 0, mixes, alpha0

    def circle_fold(log):
        return rnd(1 << log, 4), [circle.twiddle_stage(log, 0, True, dev)], alpha0

    err = 0
    for name, args in (("circle fold 2^19", circle_fold(19)),
                       ("layer 2^18, 2 folds, inputs 18, 17", layer(19, 18, 2, (18, 17))),
                       ("layer 2^12, 3 folds, input 10", layer(19, 12, 3, (10,))),
                       ("circle fold 2^23", circle_fold(23))):
        err |= check(f"fri_layer {name}", lambda: kernels.fri_layer(*args), lambda: kernels.fri_layer_plain(*args))
    del args
    args = layer(23, 22, 2, (22,))
    err |= check("fri_layer layer 2^22, 2 folds, input 22", lambda: kernels.fri_layer(*args),
                 lambda: kernels.fri_layer_plain(*args))
    work = fri_layer_work({"values": args[0], "twiddles": args[1], "mixes": args[4]})
    return dict(shape="the PINN's first committed layer: 2^22 rows, 2 folds, the input of circle log 22 joining",
                err=err, ms=time_ms(lambda: kernels.fri_layer(*args)),
                plain_ms=time_ms(lambda: kernels.fri_layer_plain(*args)), bound=bound(*work))


def quotient_groups(circle, rng, rnd, spec):
    """K4's groups of one call, the constants derived from sample points as
    a prove derives them (pcs/quotients.quotient_groups): `spec` lists
    (log, columns, point) per group, a point one of "z" (drawn on the
    circle), "z-" and "z+" (z minus and plus the log's generator), or
    "zero" (its line meets row 5 of the log's domain)."""
    from luminair_tpu_torch.pcs import quotients

    P = (1 << 31) - 1
    z = circle.point_from_t_qm31(torch.from_numpy(rng.integers(0, P, 4)))
    samples, evals, points = [], {}, {}
    for log, n_cols, kind in spec:
        key = (kind, log)
        if key not in points:
            if kind == "zero":
                x, y = (t.to(torch.int64)[5].item() for t in circle.domain_table(log, torch.device("cpu")))
                points[key] = tuple(torch.tensor([c, 0] + list(rng.integers(1, P, 2))) for c in (x, y))
            elif kind == "z":
                points[key] = z
            else:
                g = circle.point_to_qm31(circle.group_gen(log))
                points[key] = (circle.point_sub_qm31 if kind == "z-" else circle.point_add_qm31)(z, g)
        for _ in range(n_cols):
            col = (0, len(evals))
            evals[col] = rnd(1 << log)
            samples.append(quotients.ColumnSample(log, *col, points[key], rng.integers(0, P, 4).astype(np.uint32)))
    return quotients.quotient_groups(samples, evals, torch.from_numpy(rng.integers(0, P, 4)))


# The (commit log, point) groups of the N=256 prove, in its order.
N256_QUOTIENT_GROUPS = [(18, 12, "z"), (17, 56, "z"), (17, 8, "z-"), (18, 4, "z-"), (19, 4, "z")]


def quotient_kernel(kernels, circle, dev, rng, rnd, check):
    """K4 against its twin on groups from real sample points: the N=256
    prove's five groups in one call, its log-17 group of 56 columns alone
    (timed with its plan, as the one-group design was, and as the launch of
    a built plan), three points at one log, a line that meets a domain row,
    and logs below a CTA's rows."""
    def many(plan):
        return torch.cat([v.reshape(-1) for v in kernels.deep_quotient_many(plan).values()])

    def many_plain(plan):
        return torch.cat([v.reshape(-1) for v in kernels.deep_quotient_many_plain(plan).values()])

    err, plans = 0, {}
    for name, spec in (("N=256 groups", N256_QUOTIENT_GROUPS), ("log 17, S = 56", [(17, 56, "z")]),
                       ("three points at 2^12", [(12, 30, "z"), (12, 7, "z-"), (12, 5, "z+")]),
                       ("a line through a row", [(10, 9, "zero"), (10, 4, "z")]),
                       ("logs 0-8", [(0, 3, "z"), (1, 2, "z-"), (5, 7, "z"), (8, 300, "z"), (8, 2, "z+")])):
        plan = kernels.QuotientPlan(quotient_groups(circle, rng, rnd, spec))
        err |= check(f"deep_quotient {name}", lambda: many(plan), lambda: many_plain(plan))
        plans[name] = plan
    plan = plans["log 17, S = 56"]
    emit({"phase": "kernel_time_extra", "kernel": "deep_quotient", "shape": "log 17, S = 56, a built plan (launch)",
          "ms": time_ms(lambda: kernels.deep_quotient_many(plan))})
    return dict(shape="log 17, S = 56, from its sample point (plan, upload, launch)", err=err,
                ms=time_ms(lambda: kernels.deep_quotient_many(kernels.QuotientPlan(plan.groups))),
                plain_ms=time_ms(lambda: kernels.deep_quotient_many_plain(plan)), bound=bound(*quotient_work(plan)))


def channel_tree(kernels, cols_by_log, state, on_card: bool) -> torch.Tensor:
    """A FRI layer's tree with K8's step from a copy of `state`: through K2's
    root pass (on_card) or the plain tree and step.  Returns its digests,
    the state after the step and the record slot."""
    bottom = max(cols_by_log)
    desc = kernels.TreeDesc(kernels.tree_layers(bottom, state.device), cols_by_log)
    st, slot = state.clone(), torch.zeros(12, dtype=torch.int32, device=state.device)
    if on_card:
        kernels.merkle_tree(desc, st, slot)
    else:
        kernels.merkle_tree_plain(desc)
        kernels.channel_mix_root_draw_plain(st, desc.layers[0][0], slot)
    return torch.cat([desc.layers[log].reshape(-1) for log in range(bottom, -1, -1)] + [st, slot])


# The latency of one dependent Blake2s compression on one thread, which
# bounds K8's steps (blake2s_latency sets it before the first path), and
# K5's and K6's rate (field_rate, before the kernels' checks).
MEASURED = {}


def blake2s_latency(dev, n: int = 1000) -> float:
    """`n` chained compressions on one thread (tools/blake2s_latency.cu's
    lum_blake2s_chain), timed by clock64() and by CUDA events; the least
    time of one, from its cycles at the card's highest SM clock (nvidia-smi
    clocks.max.sm), is K8's latency unit.  Beside it, `n` times one
    compression's chain of 240 dependent operations written out apart from
    csrc/ (lum_blake2s_critical_path): the floor of one compression on one
    thread, whatever the code."""
    stream = torch.cuda.current_stream(dev).cuda_stream

    def cycles_of(sym, words):
        io = torch.arange(words, dtype=torch.int32, device=dev)
        cycles = torch.zeros(1, dtype=torch.int64, device=dev)
        if PROBE[sym](io.data_ptr(), 10, cycles.data_ptr(), stream) != 0:
            raise AssertionError(f"{sym}: launch failed")
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        if PROBE[sym](io.data_ptr(), n, cycles.data_ptr(), stream) != 0:
            raise AssertionError(f"{sym}: launch failed")
        end.record()
        end.synchronize()
        return int(cycles.item()), start.elapsed_time(end)

    chain, chain_ms = cycles_of("lum_blake2s_chain", 24)
    floor, floor_ms = cycles_of("lum_blake2s_critical_path", 6)
    clocks = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=clocks.sm,clocks.max.sm",
                             "--format=csv,noheader,nounits"], check=True, capture_output=True, text=True,
                            timeout=60).stdout.strip().split(",")
    sm_mhz, max_mhz = (float(c) for c in clocks)
    MEASURED["blake2s_latency_s"] = chain / n / (max_mhz * 1e6)
    emit({"phase": "blake2s_latency", "compressions": n, "cycles": chain, "cycles_per_compression": chain / n,
          "event_ms": chain_ms, "ns_per_compression_events": chain_ms * 1e6 / n,
          "critical_path_cycles_per_compression": floor / n, "critical_path_cycles_per_operation": floor / n / 240,
          "critical_path_ns_per_compression_events": floor_ms * 1e6 / n,
          "compression_over_critical_path": chain / floor,
          "sm_clock_mhz_after": sm_mhz, "max_sm_clock_mhz": max_mhz,
          "ns_per_compression_at_max_clock": MEASURED["blake2s_latency_s"] * 1e9,
          "critical_path_ns_at_max_clock": floor / n / max_mhz * 1e3})
    return MEASURED["blake2s_latency_s"]


# tools/field_rate.cu's modes: (name, operations a thread a step as the
# bounds count them, steps a launch).
FIELD_RATE_MODES = (
    ("m31_mul", 8 * OPS_MUL, 4096),
    ("m31_add", 8 * OPS_ADD, 8192),
    ("qm31_mul_add", 4 * (OPS_QMUL + 4 * OPS_ADD), 512),
)


def field_rate(dev, reps: int = 5) -> float:
    """Each mode of tools/field_rate.cu on 16 CTAs of 256 threads an SM,
    timed by CUDA events (the best of `reps` launches after one warm-up):
    the operations that the bounds count (OPS_MUL, OPS_ADD, OPS_QMUL) a
    second.  K5's and K6's rate (field_ops_per_s) is the highest of these
    and of the two pipes' issue ceiling, INT32_ISSUE_OPS_PER_S."""
    props = torch.cuda.get_device_properties(dev)
    blocks, threads = 16 * props.multi_processor_count, 256
    io = torch.randint(1, (1 << 31) - 1, (8 + blocks * threads,), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    line = {"phase": "field_rate", "sms": props.multi_processor_count, "blocks": blocks, "threads": threads}
    rates = []
    for mode, (name, ops, steps) in enumerate(FIELD_RATE_MODES):
        times = []
        for _ in range(reps + 1):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            if PROBE["lum_field_rate"](mode, io.data_ptr(), steps, blocks, threads, stream) != 0:
                raise AssertionError(f"field_rate {name}: launch failed")
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        best = min(times[1:])
        rates.append(blocks * threads * steps * ops / (best * 1e-3))
        line.update({f"{name}_ms": best, f"{name}_ops_per_s": rates[-1]})
    MEASURED["field_ops_per_s"] = max(INT32_ISSUE_OPS_PER_S, *rates)
    clocks = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=clocks.sm,clocks.max.sm",
                             "--format=csv,noheader,nounits"], check=True, capture_output=True, text=True,
                            timeout=60).stdout.strip().split(",")
    emit({**line, "alu_ops_per_s": INT32_OPS_PER_S, "issue_ops_per_s": INT32_ISSUE_OPS_PER_S,
          "k5_k6_ops_per_s": MEASURED["field_ops_per_s"], "sm_clock_mhz_after": float(clocks[0]),
          "max_sm_clock_mhz": float(clocks[1])})
    return MEASURED["field_ops_per_s"]


POW_GATE_CALLS = 20


def pow_call_gate(kernels, digest: bytes, bits: int, dev) -> int:
    """POW_GATE_CALLS K10 calls under torch.profiler (the scratch already
    made; Profiled): one launch each by the wrapper's count and by the
    host's records, one copy each and no fill of memory by the host's
    records; the device's records name no kernel but grind_pow_kernel and
    no copy but device-to-host ones (no fill, no upload), and with the
    calls that have none they make up the host's counts.  Returns the
    nonce."""
    kernels.grind_pow(digest, bits, dev)
    before = kernels.GRIND_POW.launches
    nonces = set()
    p = Profiled(lambda: nonces.update(kernels.grind_pow(digest, bits, dev) for _ in range(POW_GATE_CALLS)),
                 "grind_pow_kernel")
    events = {k: n for k, (_, n) in p.device.items()}
    launches = (kernels.GRIND_POW.launches - before) / p.tries
    emit({"phase": "pow_call_gate", "bits": bits, "nonce": min(nonces), "calls": POW_GATE_CALLS,
          "launches": launches, "host_records": p.host, "device_records": events,
          "without_a_device_record": p.lost, "device_lead_us": p.device_lead_us,
          "warm_up_recorded": p.warm_up_recorded, "windows": p.tries})
    others = [k for k in events if k != "Memcpy DtoH (Device -> Pinned)" and "grind_pow_kernel" not in k]
    lost_launches = sum(1 for _, name in p.lost if name in HOST_LAUNCH)
    if (len(nonces) != 1 or launches != POW_GATE_CALLS
            or p.host != {"launches": POW_GATE_CALLS, "copies": POW_GATE_CALLS, "memsets": 0}
            or others or p.count("grind_pow_kernel") + lost_launches != POW_GATE_CALLS
            or p.count("Memcpy DtoH") + len(p.lost) - lost_launches != POW_GATE_CALLS
            or not p.count("grind_pow_kernel") or not p.count("Memcpy DtoH")):
        raise AssertionError(f"grind_pow at {bits} bits: not one launch and one download a call: {p.host}, "
                             f"{events}, lost {p.lost}")
    return nonces.pop()


def transcript_kernels(kernels, f, dev, rng, rnd, check):
    """K8 on random channel states (alpha0's draw; the step in K2's root
    pass on FRI layers' trees of one pass, of two and of three, the root
    pass hashing 2^0 to 2^10 nodes), K9 on a pass over trees of the PINN's
    sizes, K10 at 0, 5, 12 and 16 bits and on a digest whose first passing
    nonce lies beyond the first round, each call profiled
    (pow_call_gate).  Their times come from the 80-bit path's own calls
    (transcript_kernel_rows)."""
    from luminair_tpu_torch.crypto.channel import Blake2sChannel

    blake2s_latency(dev)
    for counter in (0, 3):
        state = rnd(kernels.CHANNEL_WORDS)
        state[8] = counter

        def draw(fn):
            def run():
                st, out = state.clone(), torch.zeros(4, dtype=torch.int32, device=dev)
                return torch.cat([fn(st, out), out])
            return run

        check(f"fri_channel draw counter {counter}", draw(kernels.channel_draw_felt),
              draw(kernels.channel_draw_felt_plain))
    for counter, log in ((0, 0), (3, 10), (7, 11), (250, 16), (1, 21), (2, 22)):
        state = rnd(kernels.CHANNEL_WORDS)
        state[8] = counter
        cols = {log: rnd(1 << log, 4).t()}
        check(f"fri_channel step in the root pass, FRI layer 2^{log}, counter {counter}",
              lambda: channel_tree(kernels, cols, state, True), lambda: channel_tree(kernels, cols, state, False))
    # K9: a pass over a FRI-sized tree and a main-tree-sized tree, 64
    # queries' worth of positions at several logs.
    from luminair_tpu_torch.crypto.merkle import MerkleTree

    trees = [MerkleTree({20: rnd(1 << 20, 4).t()}),
             MerkleTree({22: rnd(12, 1 << 22), 21: rnd(30, 1 << 21), 17: rnd(3, 1 << 17)})]
    queries = [{20: np.unique(rng.integers(0, 1 << 20, 256))},
               {22: np.unique(rng.integers(0, 1 << 22, 128)), 21: np.unique(rng.integers(0, 1 << 21, 128)),
                17: np.unique(rng.integers(0, 1 << 17, 128))}]
    plan = kernels.DecommitPass([t.desc for t in trees], queries)
    check("decommit 2 trees", lambda: kernels.decommit(plan), lambda: kernels.decommit_plain(plan))
    # Above shared memory: 8,000 queries at logs 22 and 21 merge up to
    # 24,000 positions at log 21, so the position lists go to device memory.
    big = [{22: np.unique(rng.integers(0, 1 << 22, 8000)), 21: np.unique(rng.integers(0, 1 << 21, 8000)),
            17: np.unique(rng.integers(0, 1 << 17, 2000))}]
    plan = kernels.DecommitPass([trees[1].desc], big)
    if plan.in_shared:
        raise AssertionError("the large decommit pass fits in shared memory: it does not test the scratch path")
    check(f"decommit above shared memory (cap {plan.cap})", lambda: kernels.decommit(plan),
          lambda: kernels.decommit_plain(plan))
    del trees, plan
    # K10: random digests at 0-16 bits, then the first seed whose 16-bit
    # nonce lies beyond the first round (W nonces); each against the twin
    # on the card and the host channel (hashlib).
    W = kernels.pow_ctas(16, torch.cuda.get_device_properties(dev).multi_processor_count) * kernels.POW_THREADS
    cases = [(rng.integers(0, 1 << 32, 8, dtype=np.uint64).astype("<u4").tobytes(), bits) for bits in (0, 5, 12, 16)]
    seed = 0
    while True:
        digest = np.random.default_rng(seed).integers(0, 1 << 32, 8, dtype=np.uint64).astype("<u4").tobytes()
        if kernels.grind_pow(digest, 16, dev) >= W:
            break
        seed += 1
    cases.append((digest, 16))
    for i, (digest, bits) in enumerate(cases):
        nonce = pow_call_gate(kernels, digest, bits, dev)
        ch = Blake2sChannel()
        ch.digest = digest
        name = f"grind_pow {bits} bits, nonce {nonce}" + (f" (seed {seed}: beyond the first round of {W})"
                                                          if i == len(cases) - 1 else "")
        if not ch.check_pow_nonce(bits, nonce) or any(ch.check_pow_nonce(bits, n) for n in range(min(nonce, 4096))):
            raise AssertionError(f"{name}: {nonce} is not the least passing nonce")
        check(name, lambda: torch.tensor([kernels.grind_pow(digest, bits, dev)]),
              lambda: torch.tensor([kernels.grind_pow_plain(digest, bits, dev)]))


def tape_kernels(kernels, f, dev, pinn_logs, rng, rnd, check):
    """K5, K6 and the check on the tape of every PINN component at its
    batch-256 trace size (2^n rows; K6 at its commit size, 2^(n+1) rows,
    blowup 1); timed on mul, the largest (2^21 and 2^22 rows)."""
    from luminair_tpu_torch.air import tape
    from luminair_tpu_torch.air.components import COMPONENTS_BY_NAME

    ew = [[tuple(int(x) for x in rng.integers(0, f.P, 4)) for _ in range(2)] for _ in tape.ELEM_KINDS]
    err5 = err6 = err_check = 0
    rows = {}
    for name, n in pinn_logs.items():
        comp = COMPONENTS_BY_NAME[name]
        tpw = tape.record(comp, witness=True)
        main = [rnd(1 << n) for _ in comp.MAIN]
        pp = [rnd(1 << n) for _ in comp.PP_IDS]
        err5 |= check(f"air_witness {name} 2^{n}", lambda: torch.cat([o.reshape(-1) for o in kernels.air_witness(tpw, main, pp, ew)]),
                      lambda: torch.cat([o.reshape(-1) for o in tape.witness_plain(tpw, main, pp, ew)]))
        if name == "mul":
            wa = {"comps": [(tpw, main, pp)]}
            rows["air_witness"] = dict(
                shape=f"mul, 2^{n} rows, {len(main)} columns, E = {tpw.n_relations}", err=0,
                ms=time_ms(lambda: kernels.air_witness(tpw, main, pp, ew)),
                plain_ms=time_ms(lambda: tape.witness_plain(tpw, main, pp, ew)),
                bound=bound(*witness_work(wa)), bound_alu=bound(*witness_work(wa, alu_only=True)),
                bound_before=bound(*witness_work(wa, False)),
            )
        del main, pp
        tpd = tape.record(comp)
        cargs = (
            tpd, [rnd(1 << n) for _ in comp.MAIN], [rnd(1 << n) for _ in comp.PP_IDS],
            [rnd(1 << n) for _ in range(4 * tpd.n_relations)], rnd(1 << n),
            tuple(int(x) for x in rng.integers(0, f.P, 4)), ew,
        )
        err_check |= check(f"air_check {name} 2^{n}", lambda: kernels.air_check(*cargs),
                           lambda: tape.check_plain(*cargs))
        if name == "mul":
            a = dict(zip(("tp", "main", "pp", "inter", "is_first"), cargs))
            rows["air_check"] = dict(
                shape=f"mul, 2^{n} rows, K = {tpd.n_constraints}, E = {tpd.n_relations}", err=0,
                ms=time_ms(lambda: kernels.air_check(*cargs)), plain_ms=time_ms(lambda: tape.check_plain(*cargs)),
                bound=bound(*check_work(a)),
            )
        del cargs
        m = 1 << (n + 1)
        args = (
            tpd, [rnd(m) for _ in comp.MAIN], [rnd(m) for _ in comp.PP_IDS],
            [rnd(m) for _ in range(4 * tpd.n_relations)], rnd(m),
            tuple(int(x) for x in rng.integers(0, f.P, 4)), ew,
            [tuple(int(x) for x in rng.integers(0, f.P, 4)) for _ in range(tpd.n_pows)], n, 2,
        )
        err6 |= check(f"air_domain {name} 2^{n + 1}", lambda: kernels.air_domain(*args), lambda: tape.domain_plain(*args))
        if name == "mul":
            da = domain_call(args)
            rows["air_domain"] = dict(
                shape=f"mul, 2^{n + 1} rows (blowup 1), K = {tpd.n_constraints}, E = {tpd.n_relations}", err=0,
                ms=time_ms(lambda: kernels.air_domain(*args)),
                plain_ms=time_ms(lambda: tape.domain_plain(*args)),
                bound=bound(*domain_work(da)), bound_alu=bound(*domain_work(da, alu_only=True)),
                bound_before=bound(*domain_work(da, True)),
            )
        del args
    rows["air_witness"]["err"], rows["air_domain"]["err"], rows["air_check"]["err"] = err5, err6, err_check
    return rows


def oods_kernel(kernels, circle, f, dev, rng, rnd, check):
    """K7 against its twin: the composition's 4 columns at 2^22 (timed, one
    group), a 64-column group at 2^21 (the main and interaction columns of
    mul and sum_reduce), the two in one call, and a call of groups below,
    at and above a chunk (2^11 rows) with one of more than 256 columns."""
    from luminair_tpu_torch import fft

    def group(log, C):
        point = circle.point_from_t_qm31(torch.from_numpy(rng.integers(0, f.P, 4)))
        return [rnd(1 << log) for _ in range(C)], fft.twiddle_chain(log, point)

    comp, wide = group(22, 4), group(21, 64)
    err, rows = 0, {}
    for name, groups in (("4 x 2^22", [comp]), ("64 x 2^21", [wide]), ("4 x 2^22 and 64 x 2^21", [comp, wide]),
                         ("2^0, 2^5, 2^11, 2^12, 300 x 2^6", [group(0, 3), group(5, 7), group(11, 3), group(12, 20),
                                                               group(6, 300)])):
        err |= check(f"oods_eval {name}", lambda: kernels.oods_eval_many(groups),
                     lambda: kernels.oods_eval_many_plain(groups))
        ms = time_ms(lambda: kernels.oods_eval_many(groups))
        work = [oods_work(len(cols), len(chain)) for cols, chain in groups]
        b = bound(sum(w[0] for w in work), sum(w[1] for w in work))
        line = {"phase": "kernel_time_extra", "kernel": "oods_eval", "shape": name, "ms": ms, "bound_ms": b[0],
                "bound_by": b[1]}
        if len(groups) == 1:
            # Earlier yardsticks: reduced products and sums (4 OPS_MUL + 4
            # OPS_ADD a coefficient), with the factored basis and with a
            # basis product per row, as the previous K7 design computed.
            C, log = len(groups[0][0]), len(groups[0][1])
            n = 1 << log
            line["mul_add_bound_ms"] = bound(*oods_work(C, log, 4 * OPS_MUL + 4 * OPS_ADD))[0]
            line["per_row_basis_bound_ms"] = bound(4 * C * n + 16 * C,
                                                   C * n * (4 * OPS_MUL + 4 * OPS_ADD) + n * OPS_QMUL)[0]
        emit(line)
        if name == "4 x 2^22":
            rows["oods_eval"] = dict(shape="4 columns x 2^22", err=0, ms=ms,
                                     plain_ms=time_ms(lambda: kernels.oods_eval_many_plain(groups)), bound=b)
    rows["oods_eval"]["err"] = err
    return rows


def bench_graph(T, n: int):
    """The bench graph, compiled: (graph, retrieved tensor)."""
    cx = T.Graph()
    rng = np.random.default_rng(0)
    a = cx.tensor((n, n)).set(rng.normal(size=(n, n)))
    b = cx.tensor((n, n)).set(rng.normal(size=(n, n)))
    out = (a * b + a).retrieve()
    cx.compile()
    return cx, out


def pinn_inputs(BS):
    """Weights from load_weights() (a seeded initialisation when
    examples/model/weights.npz is absent), inputs drawn as the flagship
    bench draws them."""
    rng = np.random.default_rng(7)
    xs = np.column_stack([rng.uniform(5.0, 30.0, PINN_BATCH), rng.uniform(0.05, 1.0, PINN_BATCH)])
    return BS.load_weights(), xs


def pinn_graph(T, BS):
    """The PINN at batch 256, compiled: (graph, retrieved tensor)."""
    w, xs = pinn_inputs(BS)
    cx = T.Graph()
    x, out = BS.build(cx, w, batch=PINN_BATCH)
    x.set(xs)
    cx.compile()
    return cx, out


def trace_cells(pie) -> int:
    return sum(t.n_rows * len(t.columns) for t in pie.trace_tables.values() if t.n_rows)


def host_trace(build):
    """Settings and PIE from the host interpreter, each timed."""
    from luminair_tpu_torch.graph import trace as host

    cx, _ = build()
    t0 = time.perf_counter()
    settings = host.gen_circuit_settings_host(cx)
    settings_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pie = host.gen_trace_host(cx, settings)
    return pie, settings, settings_s, time.perf_counter() - t0


def card_trace(T, cx, counts=None):
    """Settings and PIE from the user's entry points (on the card by
    default), each timed to a synchronise; with `counts`, also the
    launches each of the two made.  Also the sub-spans of the two passes
    (graph/device_trace.py), with tracing on: each ended by a synchronise."""
    from luminair_tpu_torch import tracing

    with tracing.enable():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        settings = T.gen_circuit_settings(cx)
        torch.cuda.synchronize()
        settings_s = time.perf_counter() - t0
        spans = {"settings": tracing.last_phases("settings")}
        after_settings = counts() if counts else None
        t0 = time.perf_counter()
        pie = T.gen_trace(cx, settings)
        torch.cuda.synchronize()
        trace_s = time.perf_counter() - t0
        spans["trace"] = tracing.last_phases("trace")
    stages = None
    if counts:
        after = counts()
        stages = {"settings": {k: v for k, v in after_settings.items() if v},
                  "trace": {k: after[k] - after_settings[k] for k in after if after[k] > after_settings[k]}}
    return pie, settings, settings_s, trace_s, stages, spans


def pie_mismatches(f, card_pie, host_pie) -> list:
    """Where a PIE on the card differs from the host's: tables, column
    lists, rows, any word of any column (downloaded here), op counter."""
    if list(card_pie.trace_tables) != list(host_pie.trace_tables):
        return [("tables", list(card_pie.trace_tables), list(host_pie.trace_tables))]
    bad = []
    for name, ht in host_pie.trace_tables.items():
        ct = card_pie.trace_tables[name]
        if list(ct.columns) != list(ht.columns) or ct.n_rows != ht.n_rows:
            bad.append((name, "columns"))
            continue
        bad += [(name, col) for col, v in ht.columns.items() if not np.array_equal(f.tensor_to_u32(ct.columns[col]), v)]
    if dict(card_pie.metadata.execution_resources.op_counter) != dict(host_pie.metadata.execution_resources.op_counter):
        bad.append(("op_counter",))
    return bad


def native_verify(serde, proof_bytes: bytes, settings, tag: str, expect_accept: bool = True) -> float:
    """Run native/'s verifier on the flat proof through the port's binding
    (luminair_tpu_torch/native.py; the library is built first, outside the
    timed call); it must accept it (or, with expect_accept False, reject
    it).  Returns the seconds of the verify call."""
    from luminair_tpu_torch import native

    native.build()
    settings_bytes = serde.settings_to_flat_bytes(settings)
    t0 = time.perf_counter()
    try:
        native.verify_flat(proof_bytes, settings_bytes)
        accepted, why = True, ""
    except native.NativeVerifierError as e:
        accepted, why = False, str(e)
    verify_s = time.perf_counter() - t0
    if accepted != expect_accept:
        raise AssertionError(f"{tag}: native verifier {'rejected' if expect_accept else 'accepted'} the proof {why}")
    return verify_s


class tree_bottoms:
    """While active, the bottom log of every tree K2 hashes, in a list."""

    def __init__(self, kernels):
        self.kernels, self.fn, self.bottoms = kernels, kernels.merkle_tree, []

    def _counted(self, desc, *channel, **start):
        self.bottoms.append(desc.bottom)
        return self.fn(desc, *channel, **start)

    def __enter__(self):
        self.kernels.merkle_tree = self._counted
        return self.bottoms

    def __exit__(self, *exc):
        self.kernels.merkle_tree = self.fn
        return False


def path_launches(kernels, tag, first_s, launches, bottoms, expect, k3_limit, proof):
    """The path line: launches of one run with the counters reset just
    before it (one prove), and K2's trees with the launches they may take
    (ceil((L + 1) / (t + 1)) each).  Fails if a kernel of the path never
    launched, K2 took more, K7 more than one call (two launches) per prove,
    K4 more than one, K5 or K6 other than one, K3 more than `k3_limit` (one
    a committed FRI layer and one for the largest input's circle fold), K8
    other than one launch
    (alpha0) with one step in a K2 root pass per committed FRI layer, or
    K10 other than one."""
    limit = sum(-(-(b + 1) // (kernels.MERKLE_TILE_LOG + 1)) for b in bottoms)
    fri_layers, in_root_passes = len(proof.pcs_proof.fri_proof.layer_roots), kernels.CHANNEL.hosted
    emit({"phase": "path", "path": tag, "first_prove_seconds": first_s, "launches": launches,
          "merkle_trees": len(bottoms), "merkle_tree_bottoms": bottoms, "merkle_launch_limit": limit,
          "fri_layer_launch_limit": k3_limit, "fri_layers": fri_layers,
          "fri_channel_steps_in_root_passes": in_root_passes})
    missing = [k for k in expect if launches[k] == 0]
    if missing:
        raise AssertionError(f"{tag}: the path launched no {missing}")
    if launches["blake2s_merkle"] > limit or launches["oods_eval"] > 1 or launches["deep_quotient"] > 1:
        raise AssertionError(f"{tag}: K2 took {launches['blake2s_merkle']} launches (at most {limit}), "
                             f"K7 {launches['oods_eval']} calls, K4 {launches['deep_quotient']} (at most 1 each)")
    if launches["fri_layer"] > k3_limit:
        raise AssertionError(f"{tag}: K3 took {launches['fri_layer']} launches (at most {k3_limit})")
    if launches["air_witness"] != 1 or launches["air_domain"] != 1:
        raise AssertionError(f"{tag}: K5 took {launches['air_witness']} launches and K6 {launches['air_domain']}: "
                             "one each a prove on one device")
    if launches["fri_channel"] != 1 or in_root_passes != fri_layers or launches["grind_pow"] != 1:
        raise AssertionError(f"{tag}: K8 took {launches['fri_channel']} launches and {in_root_passes} steps in root "
                             f"passes ({fri_layers} FRI layers), K10 {launches['grind_pow']}: 1, {fri_layers}, 1 "
                             "expected")
    return in_root_passes


def segment_launch_gate(tag, stages) -> None:
    """trace_segment launches once per segment: a trace's segments are cut at
    its reductions (T3), a settings pass's at its LUT nodes (one T4 each)
    too."""
    for stage, cuts in (("trace", ("trace_reduce",)), ("settings", ("trace_reduce", "lut_boundary"))):
        got = stages[stage].get("trace_segment", 0)
        most = 1 + sum(stages[stage].get(k, 0) for k in cuts)
        if not 1 <= got <= most:
            raise AssertionError(f"{tag}: the {stage} pass made {got} trace_segment launches (1 to {most})")


def phase_path(T, kernels, serde, tracing, f, card, tag, build, host, expect, k3_limit, check_output=None):
    """One path.  `host` is the host interpreter's (PIE, settings, seconds,
    seconds).  With every launch counter set to 0 just before it and read
    just after: the card's settings, trace and first prove through the
    user's entry points (each kernel in `expect` must have launched).  Then
    the card's PIE and settings against the host's (downloaded after the
    timed window), two more timed card traces, the median of 3 proves, a
    prove of the host's PIE (the same bytes), and the native verifier."""
    host_pie, host_settings, host_settings_s, host_trace_s = host
    cx, out = build()
    with tree_bottoms(kernels) as bottoms:
        kernels.reset_counts()
        pie, settings, settings_s, trace_s, stage_launches, spans = card_trace(T, cx, kernels.counts)
        t0 = time.perf_counter()
        proof = T.prove(pie, settings)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launches = kernels.counts()
    launches["fri_channel_steps_in_root_passes"] = path_launches(kernels, tag, first_s, launches, bottoms, expect,
                                                                 k3_limit, proof)
    segment_launch_gate(tag, stage_launches)

    card_s = [(settings_s, trace_s, spans)] + [card_trace(T, build()[0])[2:] for _ in range(2)]
    card_s = [(c[0], c[1], c[-1]) for c in card_s]
    bad = pie_mismatches(f, pie, host_pie)
    same_settings = serde.settings_to_flat_bytes(settings) == serde.settings_to_flat_bytes(host_settings)
    line = {
        "phase": "trace", "path": tag, "card": card, "trace_cells": trace_cells(pie),
        "settings_host_seconds": host_settings_s, "trace_host_seconds": host_trace_s,
        "settings_card_seconds": [c[0] for c in card_s], "trace_card_seconds": [c[1] for c in card_s],
        "settings_card_seconds_median": statistics.median(c[0] for c in card_s),
        "trace_card_seconds_median": statistics.median(c[1] for c in card_s),
        "pie_equals_host": not bad, "settings_bytes_equal_host": same_settings,
        "launches": stage_launches,
        "settings_spans_s": [c[2]["settings"] for c in card_s], "trace_spans_s": [c[2]["trace"] for c in card_s],
        "tables": {k: [t.n_rows, t.log_size, len(t.columns)] for k, t in pie.trace_tables.items()},
    }
    if check_output is not None:
        line.update(check_output(out))
    emit(line)
    if bad or not same_settings:
        raise AssertionError(f"{tag}: the card's PIE or settings differ from the host's: {bad[:8]}")
    if line.get("model_max_abs_err", 0.0) >= 0.05:
        raise AssertionError(f"{tag}: output drifts {line['model_max_abs_err']} from its float64 forward pass")

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
        raise AssertionError(f"{tag}: repeated proves of one PIE differ")
    if serde.proof_to_flat_bytes(T.prove(host_pie, host_settings)) != pb:
        raise AssertionError(f"{tag}: the proof of the host's PIE differs from the proof of the card's")
    verify_s = native_verify(serde, pb, settings, tag)
    cells = trace_cells(pie)
    emit({
        "phase": "prove", "path": tag, "card": card, "trace_cells": cells, "prove_seconds": times,
        "prove_seconds_median": med, "trace_cells_per_s": cells / med,
        "phases_s": phases[times.index(med)], "proof_bytes": len(pb),
        "peak_device_bytes": torch.cuda.max_memory_allocated(),
        "self_check": "passed", "host_pie_proof_equal": True,
        "native_verify": "accepted", "native_verify_seconds": verify_s,
    })
    return launches, pie, settings, proof


# The wrappers a path calls: the kernel each launches, its plain twin on
# the call's bound arguments, and the arguments whose shapes (or, for a
# tape, its component) set the work of the call.  A trace step's twin takes
# the step itself.
def path_twins(kernels, tape, f):
    return {
        "circle_ifft": ("circle_fft", lambda a: kernels.circle_ifft_plain(a["values"]), ("values",)),
        "circle_fft": ("circle_fft", lambda a: kernels.circle_fft_plain(a["coeffs"], a["m_start"]),
                       ("coeffs", "m_start")),
        "circle_lde": ("circle_fft", lambda a: kernels.circle_lde_plain(a["coeffs"], a["log_blowup"]),
                       ("coeffs", "log_blowup")),
        "merkle_tree": ("blake2s_merkle", lambda a: kernels.merkle_tree_plain(a["desc"]), ("desc", "state")),
        "fri_layer": ("fri_layer", lambda a: kernels.fri_layer_plain(
            a["values"], a["twiddles"], a["alpha"], a["t0"], a["mixes"], a["alpha0"]), ("values", "twiddles", "mixes")),
        "deep_quotient_many": ("deep_quotient", lambda a: kernels.deep_quotient_many_plain(a["plan"]), ("plan",)),
        "air_witness_many": ("air_witness", lambda a: kernels.air_witness_many_plain(a["comps"], a["ew"]),
                             ("comps",)),
        "add_carry": ("add_carry", lambda a: kernels.add_carry_plain(a["rows"], a["carry"]), ("rows",)),
        "air_domain_many": ("air_domain", lambda a: kernels.air_domain_many_plain(a["blocks"], a["ew"]),
                            ("blocks",)),
        "oods_eval_many": ("oods_eval", lambda a: kernels.oods_eval_many_plain(a["groups"]), ("groups",)),
        "channel_draw_felt": ("fri_channel", lambda a: kernels.channel_draw_felt_plain(a["state"], a["out"]), ()),
        "decommit": ("decommit", lambda a: kernels.decommit_plain(a["plan"]), ("plan",)),
        "grind_pow": ("grind_pow", lambda a: kernels.grind_pow_plain(a["digest"], a["bits"], a["device"]), ("bits",)),
        **trace_twins(kernels),
    }


def trace_twins(kernels):
    return {
        "trace_segment": ("trace_segment", kernels.trace_segment_plain, ("seg",)),
        "trace_reduce": ("trace_reduce", kernels.trace_reduce_plain, ("s",)),
        "lut_boundary": ("lut_boundary", lambda a: kernels.lut_boundary_plain(a["src"], a["gathered"]),
                         ("src", "gathered")),
    }


def describe(x):
    """The part of an argument that sets a call's work: a tensor's shape
    (and strides when it is a view), a column list's length and column
    shape, a decommitment pass's trees and output size, a tape's
    component, a trace step's op, rows and source shapes, a trace
    segment's items (op and rows each) and whether it writes columns."""
    if isinstance(x, torch.Tensor):
        return tuple(x.shape) if x.is_contiguous() else (tuple(x.shape), x.stride())
    if isinstance(x, (list, tuple)) and x and isinstance(x[0], torch.Tensor):
        return (len(x),) + tuple(x[0].shape)
    if isinstance(x, list) and x and hasattr(x[0], "terms"):  # K6's blocks: each one's components, rows, halo
        return tuple((tuple(t.tp.name for t in b.terms), b.rows, b.stride, b.row0, b.terms[0].halo is not None)
                     for b in x)
    if isinstance(x, list) and x and isinstance(x[0], tuple) and hasattr(x[0][0], "n_relations"):  # K5's components
        return tuple((c[0].name, describe(list(c[1]) + list(c[2])), len(c) > 3 and c[3] is not None) for c in x)
    if isinstance(x, list) and all(m is None or isinstance(m[0], torch.Tensor) for m in x):  # K3's joining inputs
        return tuple(None if m is None else tuple(m[0].shape) for m in x)
    if hasattr(x, "n_ctas"):  # a DEEP-quotient plan: its groups' logs and widths (and its row shard)
        return tuple((log, len(cols)) for log, cols, _, _ in x.groups) + (getattr(x, "shard", (0, 0)),)
    if hasattr(x, "region"):  # a decommitment pass: its trees and output size
        return (tuple(t.bottom for t in x.trees), x.n_words)
    if hasattr(x, "bottom"):  # a tree: its columns' shapes and strides
        return tuple((log, describe(c)) for log, c in sorted(x.cols.items()))
    if isinstance(x, list) and x and isinstance(x[0], tuple):  # OODS groups
        return tuple(describe(cols) for cols, _ in x)
    if hasattr(x, "n_relations"):
        return x.name
    if hasattr(x, "has_columns"):  # a trace segment
        return (tuple((it.op, it.rows) for it in x.items()), x.has_columns)
    if hasattr(x, "fresh"):
        return (x.op, x.rows, x.dsize, x.back, tuple((len(b), v.shape) for b, v in x.srcs), bool(x.cols))
    return x


# Wrappers whose every call is kept and replayed, not one a shape: each K3
# layer and each T4 boundary of a path, each check of a PIE.
EVERY_CALL = ("fri_layer", "lut_boundary", "air_check_many")

# Arguments a kernel updates in place (cloned when kept and for each replay)
# and record slots it writes (fresh for each replay).
UPDATED_ARGS = ("acc", "state", "rows")
WRITTEN_ARGS = ("out",)


def flat(out, args=None) -> torch.Tensor:
    """One int32 vector of a wrapper's result (K5 returns columns and sum,
    K10 a nonce) and of the record slot it wrote."""
    if isinstance(out, int):
        out = torch.tensor([out], dtype=torch.int64)
    elif isinstance(out, dict):  # K4: per log
        out = torch.cat([v.reshape(-1) for v in out.values()])
    elif isinstance(out, (tuple, list)):  # K5: interactions and sums; K6: quotients; the carry pass: its blocks
        out = torch.cat([flat(o) if isinstance(o, (tuple, list)) else o.reshape(-1) for o in out])
    written = [args[k].reshape(-1).to(out.device, out.dtype) for k in WRITTEN_ARGS if args and args.get(k) is not None]
    return torch.cat([out.reshape(-1)] + written) if written else out


def cloned(x):
    """A copy of an argument that a kernel updates in place: a tensor, or a
    list of them (the carry pass's blocks)."""
    if isinstance(x, (list, tuple)):
        return [t.clone() for t in x]
    return x.clone() if x is not None else None


def replay_args(a: dict) -> dict:
    args = dict(a)
    for k in UPDATED_ARGS:
        if args.get(k) is not None:
            args[k] = cloned(args[k])
    for k in WRITTEN_ARGS:
        if args.get(k) is not None:
            args[k] = torch.zeros_like(args[k])
    return args


class recording:
    """While active, every wrapper in `twins` keeps the arguments of its
    first call at each distinct key (wrapper, the shapes of its work) in
    `kept` (an argument the kernel updates in place is cloned first),
    counts its calls in `calls` and sums the bound (ms) of every call of
    a wrapper in WORK or WORK_AFTER in `bound_ms`, by kernel (a settings
    pass's trace steps under the kernel's name + "_settings"; K8's step in a
    channel tree's root pass under fri_channel)."""

    def __init__(self, kernels, twins, kept, calls):
        self.kernels, self.twins, self.kept, self.calls = kernels, twins, kept, calls
        self.bound_ms, self.bound_calls = {}, {}
        self.originals = {name: getattr(kernels, name) for name in twins}

    def _recorder(self, name, fn):
        sig = inspect.signature(fn)
        key_args = self.twins[name][2]

        def rec(*args, **kw):
            ba = sig.bind(*args, **kw)
            ba.apply_defaults()
            a = dict(ba.arguments)
            self.calls[name] = self.calls.get(name, 0) + 1
            key = (name,) + tuple(describe(a[k]) for k in key_args)
            if name in EVERY_CALL:
                key += (self.calls[name],)
            if key not in self.kept:
                self.kept[key] = {k: cloned(v) if k in UPDATED_ARGS else v for k, v in a.items()}
            before = WORK_AFTER[name][0](a) if name in WORK_AFTER else None
            out = fn(*args, **kw)
            work = WORK[name](a) if name in WORK else WORK_AFTER[name][1](a, out, before) if name in WORK_AFTER else None
            if work is not None:
                kernel = self.twins[name][0]
                if is_settings_step(a):
                    kernel += "_settings"  # a step of the settings pre-pass, apart from the trace's
                self.bound_ms[kernel] = self.bound_ms.get(kernel, 0.0) + bound(*work)[0]
                self.bound_calls[kernel] = self.bound_calls.get(kernel, 0) + 1
                if name == "trace_segment":  # the nodes alone, as T1 and T2 were bounded
                    nodes = kernel.replace("trace_segment", "trace_segment_nodes")
                    self.bound_ms[nodes] = self.bound_ms.get(nodes, 0.0) + bound(*segment_work(a["seg"], True))[0]
                    self.bound_calls[nodes] = self.bound_calls.get(nodes, 0) + 1
                if name == "merkle_tree" and a["state"] is not None:  # K8's step in the root pass
                    step = bound(*channel_step_work(1 + _counter(a["state"])))[0]
                    self.bound_ms["fri_channel"] = self.bound_ms.get("fri_channel", 0.0) + step
                    self.bound_calls["fri_channel"] = self.bound_calls.get("fri_channel", 0) + 1
            return out

        return rec

    def __enter__(self):
        for name, fn in self.originals.items():
            setattr(self.kernels, name, self._recorder(name, fn))
        return self

    def __exit__(self, *exc):
        for name, fn in self.originals.items():
            setattr(self.kernels, name, fn)
        return False


def is_settings_step(a: dict) -> bool:
    """A trace step or segment of the settings pre-pass (no columns)."""
    if "seg" in a:
        return not a["seg"].has_columns
    return hasattr(a.get("s"), "fresh") and not a["s"].cols


SEGMENT_RUNS = 3  # each kept segment through the kernel, from fresh outputs each time


def segment_err(kernels, seg) -> float:
    """A segment through its kernel SEGMENT_RUNS times and through its twin,
    each from fresh outputs (a missing barrier shows as words that differ
    only sometimes); then each of its node items alone, as a one-node
    segment (trace_binary / trace_unary / trace_encode) against the op's
    twin."""
    want = seg.fresh()
    kernels.trace_segment_plain(want)
    err = 0
    for _ in range(SEGMENT_RUNS):
        got = seg.fresh()
        kernels.trace_segment(got)
        err = max(err, trace_err(got.outputs(), want.outputs()))
    for step in seg.fresh().steps():
        if step.op == "pad":
            continue
        wrapper = ("trace_binary" if step.op in ("add", "mul", "rem", "less_than")
                   else "trace_encode" if step.op == "encode" else "trace_unary")
        k, p = step.fresh(), step.fresh()
        getattr(kernels, wrapper)(k)
        getattr(kernels, wrapper + "_plain")(p)
        err = max(err, trace_err(k.outputs(), p.outputs()))
    return err


def trace_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """Largest |a - b| of two int64 vectors (0 when they are equal)."""
    if torch.equal(a, b):
        return 0
    return max(1.0, float((a.double() - b.double()).abs().max()))


def replay(kernels, twins, kept, calls) -> dict:
    """Every kept call again through its kernel and through its twin; a
    trace step writes into fresh outputs on both sides, a channel step
    starts from the kept state with a fresh record slot."""
    by_kernel = {k.name: {"calls": 0, "shapes": [], "max_abs_err": 0} for k in kernels.KERNELS}
    for name, n in calls.items():
        by_kernel[twins[name][0]]["calls"] += n
    for key, a in kept.items():
        name = key[0]
        kernel_name, plain, _ = twins[name]
        if "seg" in a:
            err = segment_err(kernels, a["seg"])
        elif "s" in a and hasattr(a["s"], "fresh"):
            k, p = a["s"].fresh(), a["s"].fresh()
            getattr(kernels, name)(k)
            plain(p)
            err = trace_err(k.outputs(), p.outputs())
        elif name == "merkle_tree" and a["state"] is not None:  # a FRI layer's tree and K8's step, from the kept state
            cols = a["desc"].cols
            err = max_abs_err(channel_tree(kernels, cols, a["state"], True),
                              channel_tree(kernels, cols, a["state"], False))
        elif name == "merkle_tree":  # each side hashes new layers over the kept columns
            cols = a["desc"].cols
            err = max_abs_err(tree_words(kernels, cols, getattr(kernels, name)),
                              tree_words(kernels, cols, kernels.merkle_tree_plain))
        else:
            ka, pa = replay_args(a), replay_args(a)
            got = flat(getattr(kernels, name)(**ka), ka)
            want = flat(plain(pa), pa)
            err = trace_err(got.to(torch.int64), want.to(torch.int64)) if got.dtype == torch.int64 else max_abs_err(got, want)
        owners = [kernel_name] + (["fri_channel"] if name == "merkle_tree" and a["state"] is not None else [])
        for owner in owners:  # a channel tree checks K2 and K8's step
            row = by_kernel[owner]
            row["shapes"].append(repr(key))
            row["max_abs_err"] = max(row["max_abs_err"], err)
    torch.cuda.synchronize()
    return by_kernel


def k1_work(name: str, a: dict):
    """(bytes, operations) of one K1 wrapper call from its arguments."""
    if name == "circle_ifft":
        x = a["values"]
        log = x.shape[1].bit_length() - 1
        return fft_work(x.numel(), x.numel(), log, log, True)
    if name == "circle_fft":
        x = a["coeffs"]
        log = x.shape[1].bit_length() - 1
        return fft_work(x.numel(), x.numel(), log, log - a["m_start"].bit_length() + 2, False)
    x, b = a["coeffs"], a["log_blowup"]
    log = x.shape[1].bit_length() - 1 + b
    return fft_work(x.numel(), x.numel() << b, log, log - (b == 1 and x.shape[1] > 1), False)


def merkle_tree_work(cols_by_log: dict):
    """(bytes, operations) of a whole tree: its columns read once, its
    digests written once; per node ceil((16 + k) / 16) compressions, k
    the column words of its log (k / 16 on the leaf layer)."""
    bottom = max(cols_by_log)
    n_bytes = sum(4 * c.numel() for c in cols_by_log.values()) + 32 * ((2 << bottom) - 1)
    blocks = 0
    for log in range(bottom + 1):
        words = (16 if log < bottom else 0) + (cols_by_log[log].shape[0] if log in cols_by_log else 0)
        blocks += (1 << log) * -(-words // 16)
    return n_bytes, blocks * OPS_BLAKE2S_BLOCK


def oods_work(n_cols: int, log_n: int, per_coeff: int = 4 * OPS_FOLD_MAC):
    """(bytes, operations) of one OODS group: the coefficients read once and
    the values written once; per coefficient 4 products into unreduced sums
    (`per_coeff` operations); the basis factored at c = ceil(L / 2): 2^c +
    2^(L - c) QM31 products, the fewest a split of the index into two
    tables needs."""
    n, c = 1 << log_n, (log_n + 1) // 2
    return 4 * n_cols * n + 16 * n_cols, n_cols * n * per_coeff + ((1 << c) + (n >> c)) * OPS_QMUL


def fri_layer_work(a: dict):
    """(bytes, operations) that one K3 call needs: the layer's 2^L rows read
    once, each fold's twiddles used (2^(L-t-1) words at fold t) read once,
    each joining input (2^(L-t) rows) and its circle twiddles read once, the
    next layer (2^(L-F) rows) written once; per output of fold t the fold (8
    products, 12 sums, a QM31 product) and, where an input joins, its
    circle fold and the mix (a QM31 product and 4 sums)."""
    rows, folds = a["values"].shape[0], len(a["twiddles"])
    fold = 8 * OPS_MUL + 12 * OPS_ADD + OPS_QMUL
    n_bytes, ops = 16 * rows + 16 * (rows >> folds), 0
    for t, mix in enumerate(a["mixes"] or [None] * folds):
        n = rows >> (t + 1)
        n_bytes += 4 * n
        ops += n * fold
        if mix is not None:
            n_bytes += 16 * 2 * n + 4 * n
            ops += n * (fold + OPS_QMUL + 4 * OPS_ADD)
    return n_bytes, ops


def quotient_work(plan):
    """(bytes, operations) that the function of one K4 call needs: per log
    the S columns of its groups, xs and ys read once and its (n, 4) output
    written once; per column and row 4 products, each a 64-bit multiply-add
    into an unfolded sum, and one fold per four; per row and group one share
    of a batched inversion, about 3 products."""
    n_bytes = ops = 0
    for log in plan.rows:
        n = 1 << (log - getattr(plan, "shard", (0, 0))[1])  # a row shard's plan: its block's rows
        widths = [len(cols) for lg, cols, _, _ in plan.groups if lg == log]
        S, G = sum(widths), len(widths)
        n_bytes += 4 * S * n + 8 * n + 16 * n
        ops += n * (S * (4 * OPS_MAC64 + OPS_FOLD) + G * 3 * OPS_MUL)
    return n_bytes, ops


def field_ops_per_s(alu_only: bool = False) -> float:
    """The rate of K5's and K6's operations: the issue ceiling of the
    ALU and FMA pipes together, or tools/field_rate.cu's best measured
    rate (field_rate) where it is higher; alu_only: the ALU pipe's
    INT32_OPS_PER_S, as the bounds counted before."""
    return INT32_OPS_PER_S if alu_only else MEASURED.get("field_ops_per_s", INT32_ISSUE_OPS_PER_S)


def witness_work(a: dict, batched: bool = True, alu_only: bool = False):
    """(bytes, operations, rate) of one K5 call (`air_witness_many`): each
    component's columns and carry read once, its 4E coordinates and
    claimed sum written once; the tape and the LogUp arithmetic per row
    (`witness_row_ops`) at field_ops_per_s.  batched=False: the count
    before the row's inverses shared one M31 inversion, at the ALU rate."""
    n_bytes = ops = 0
    for tp, main, pp, *carry in a["comps"]:
        n = (list(main) + list(pp))[0].shape[0]
        n_bytes += 4 * (len(main) + len(pp)) * n + 16 * tp.n_relations * n + 16 + (16 if carry else 0)
        ops += n * witness_row_ops(tp, batched)
    return n_bytes, ops, field_ops_per_s(alu_only or not batched)


def add_carry_work(a: dict):
    """(bytes, operations) of one carry pass: its (4, R) blocks read and
    written once, a QM31 carry a block read once; one add a word."""
    blocks = [a["rows"]] if isinstance(a["rows"], torch.Tensor) else a["rows"]
    n = sum(b.numel() for b in blocks)
    return 8 * n + 16 * len(blocks), n * OPS_ADD


def domain_work(a: dict, per_component: bool = False, alu_only: bool = False):
    """(bytes, operations, rate) of one K6 call (`air_domain_many`): per
    block its components' columns (main, pp, interaction, is_first) and
    halos and its xs read once, its (m, 4) quotients written once; per row
    each component's terms (`domain_term_ops`) and one V_n
    (`vanishing_ops`), at field_ops_per_s.  per_component: the count
    before one launch summed a domain's components, which charged each
    component its own V_n, xs and (m, 4) written, at the ALU rate."""
    n_bytes = ops = 0
    for blk in a["blocks"]:
        m, C = blk.rows, len(blk.terms)
        for t in blk.terms:
            cols = len(t.main) + len(t.pp) + len(t.inter) + 1
            halo = 0 if t.halo is None else blk.stride * (len(t.tp.next_cols) + 4)
            n_bytes += 4 * cols * m + 4 * halo
            ops += m * domain_term_ops(t.tp)
        if per_component:
            n_bytes += C * (4 + 16) * m
            ops += C * m * vanishing_ops(blk.log_trace)
        else:  # the components' terms summed in registers, one V_n, one write
            n_bytes += (4 + 16) * m
            ops += m * (vanishing_ops(blk.log_trace) + (C - 1) * 4 * OPS_ADD)
    return n_bytes, ops, field_ops_per_s(alu_only or per_component)


def domain_call(args) -> dict:
    """`air_domain_many`'s arguments of one `kernels.air_domain` call."""
    tp, main, pp, inter, is_first, claimed, ew, pows, log_trace, stride = args[:10]
    from luminair_tpu_torch import kernels

    term = kernels.DomainTerm(tp, list(main), list(pp), list(inter), is_first, claimed, list(pows))
    return {"blocks": [kernels.DomainBlock([term], log_trace, stride)], "ew": ew}


def check_work(a: dict):
    """(bytes, operations) of one air_check call: the main, preprocessed and
    interaction columns and is_first read once, one word per row written;
    the tape and the constraints' arithmetic per row."""
    tp, n = a["tp"], a["is_first"].shape[0]
    n_cols = len(a["main"]) + len(a["pp"]) + len(a["inter"]) + 1
    return 4 * (n_cols + 1) * n, n * check_row_ops(tp)


def check_many_work(a: dict):
    """(bytes, operations) of one air_check_many call: each component's."""
    works = [check_work(dict(zip(("tp", "main", "pp", "inter", "is_first"), c))) for c in a["comps"]]
    return sum(w[0] for w in works), sum(w[1] for w in works)


def channel_bytes() -> int:
    return 4 * (2 * 13 + 8 + 12)  # the state read and written, a root, a record slot


def channel_step_work(compressions: int):
    """(bytes, compressions, compressions per second) of one K8 step: its
    compressions depend each on the last, so one thread does them in turn,
    each in at least the measured latency of one (blake2s_latency)."""
    return channel_bytes(), compressions, 1 / MEASURED["blake2s_latency_s"]


# The work of one call of each wrapper whose per-run bound is summed, from
# its arguments (bytes, operations[, operations per second]).
WORK = {
    "circle_ifft": lambda a: k1_work("circle_ifft", a),
    "circle_fft": lambda a: k1_work("circle_fft", a),
    "circle_lde": lambda a: k1_work("circle_lde", a),
    "merkle_tree": lambda a: merkle_tree_work(a["desc"].cols),
    "fri_layer": fri_layer_work,
    "deep_quotient_many": lambda a: quotient_work(a["plan"]),
    "air_witness_many": witness_work,
    "air_domain_many": domain_work,
    "add_carry": add_carry_work,
    "air_check_many": check_many_work,
    "oods_eval_many": lambda a: tuple(map(sum, zip(*(oods_work(len(cols), len(chain))
                                                     for cols, chain in a["groups"])))),
    "trace_segment": lambda a: segment_work(a["seg"]),
    "trace_reduce": lambda a: step_work(a["s"]),
    "lut_boundary": lambda a: lut_boundary_work(len(a["src"]), len(a["gathered"])),
}


def lut_boundary_work(n: int, gn: int):
    """(bytes, operations, rate) of one T4 call: the source and the gathered
    input read once, the boundary written once; a compare for the min and
    one for the max per source value."""
    return 8 * n + 16 * gn + 16, 2 * n, INT64_OPS_PER_S


def _counter(state) -> int:
    return int(state[8]) & 0xFFFFFFFF


# Work that depends on the data: (before(args), after(args, result, before)).
# K8 hashes one block per draw counter step (and one to mix a root, in the
# root pass: recording), one after another; K10 hashes every nonce up to
# the one it returns.
WORK_AFTER = {
    "channel_draw_felt": (lambda a: _counter(a["state"]),
                          lambda a, out, c0: channel_step_work(_counter(a["state"]) - c0)),
    "grind_pow": (lambda a: None, lambda a, nonce, _: (40, (nonce + 1) * OPS_POW_CANDIDATE)),
}


PER_RUN_BOUND = {}  # {path: {kernel: ms}} (phase_path_kernels)


def phase_path_kernels(T, kernels, tape, f, tag: str, run, expect):
    """The path once more (`run`: settings, trace, prove on the card) with
    every wrapper recording; then each kept call through kernel and twin.
    Any word that differs fails the run, and so does a kernel of the path
    that never ran.  Also the bounds of the path's calls, summed by kernel
    (per_run_bound).  Returns ({kernel: max_abs_err}, the kept calls)."""
    twins = path_twins(kernels, tape, f)
    kept, calls = {}, {}
    with recording(kernels, twins, kept, calls) as rec:
        run()
    k9 = 0.0
    for key, a in kept.items():
        if key[0] == "decommit":
            words = sum(int(src.index_select(ax, p).numel()) for src, p, ax in decommit_specs(a["plan"]))
            k9 += bound(8 * len(a["plan"].packed) + 8 * words, 8 * words)[0]
    line = {"phase": "per_run_bound", "path": tag, "decommit_bound_ms": k9, "decommit_calls": calls.get("decommit", 0)}
    for kernel in sorted(rec.bound_ms):
        line[f"{kernel}_bound_ms"] = rec.bound_ms[kernel]
        line[f"{kernel}_calls"] = rec.bound_calls[kernel]
    emit(line)
    PER_RUN_BOUND[tag] = dict(rec.bound_ms)
    by_kernel = replay(kernels, twins, kept, calls)
    for kernel_name, row in by_kernel.items():
        emit({"phase": "path_kernel_check", "path": tag, "kernel": kernel_name, **row})
    bad = [k for k in expect if by_kernel[k]["max_abs_err"] != 0 or not by_kernel[k]["shapes"]]
    if bad:
        raise AssertionError(f"{tag}: at the path's shapes, kernels disagree with their twins or never ran: {bad}")
    return {k: r["max_abs_err"] for k, r in by_kernel.items()}, kept


# 64-bit integer operations per row of each trace op (adds, compares,
# products, divisions and the floor-mods of to_m31 counted as one each),
# plus 3 per view dimension of each operand (a division, a remainder, a
# product-add).  The card has no 64-bit integer ALU: a 64-bit operation
# takes at least two 32-bit instructions, so the rate is half the 32-bit
# one (an upper rate, hence a lower bound on time).
INT64_OPS_PER_S = INT32_OPS_PER_S / 2
TRACE_ROW_OPS = {
    "add": 8, "mul": 12, "rem": 12, "less_than": 16, "inputs": 4, "recip": 10, "square": 10, "sqrt": 14,
    "lut": 8, "contiguous": 8, "sum_reduce": 10, "max_reduce": 18, "pad": 0, "encode": 6,
}


def step_work(s):
    """(bytes, operations, rate) of one trace step: its sources read once,
    its output, columns and histogram written once; the LUT entries its
    rows read."""
    rows = s.rows * s.dsize
    n_bytes = sum(8 * len(b) for b, _ in s.srcs) + 4 * rows * len(s.cols)
    n_bytes += 8 * len(s.out) if s.out is not None else 0
    n_bytes += 4 * len(s.mult) if s.mult is not None else 0
    ops = TRACE_ROW_OPS[s.op] + sum(3 * len(v.shape) for _, v in s.srcs)
    if s.lut is not None:
        n_bytes += 8 * rows + 24 * len(s.lut[0])
        ops += 2 * len(s.lut[0]).bit_length()
    return n_bytes, rows * ops, INT64_OPS_PER_S


def step_bound(s):
    """Least time for one trace step (step_work)."""
    return bound(*step_work(s))


def segment_work(seg, nodes_only: bool = False):
    """(bytes, operations, rate) of a trace segment: step_work summed over
    its items (with nodes_only, over its nodes alone: the padding rows were
    torch fills before the segment kernel wrote them)."""
    works = [step_work(s) for s in seg.steps() if not (nodes_only and s.op == "pad")]
    return sum(w[0] for w in works), sum(w[1] for w in works), INT64_OPS_PER_S


def trace_kernel_rows(kernels, kept) -> dict:
    """trace_segment and T3 timed at the largest call each made in the
    path's trace (T4 in its settings pre-pass), against the twin on the
    card; T4 also against the composition it replaces (lut_boundary_row)."""
    largest = {}
    for key, a in kept.items():
        name = key[0]
        if name == "trace_segment":
            # A segment of the trace (with columns) before a settings segment.
            size = (a["seg"].has_columns, sum(it.rows for it in a["seg"].items()))
        elif name == "trace_reduce":
            size = (bool(a["s"].cols), a["s"].rows * a["s"].dsize)
        elif name == "lut_boundary":
            size = (True, len(a["src"]))
        else:
            continue
        if name not in largest or size > largest[name][0]:
            largest[name] = (size, a)
    for key, a in kept.items():  # every segment of the path, alone
        if key[0] == "trace_segment":
            seg = a["seg"].fresh()
            items = seg.items()
            emit({"phase": "kernel_time_extra", "kernel": "trace_segment",
                  "shape": f"{'trace' if seg.has_columns else 'settings'}: {len(items)} items, "
                           f"{len(seg.table.chains)} chains in the pass, {seg.p1 - seg.p0} phases, "
                           f"{sum(it.rows for it in items)} rows",
                  "ms": time_ms(lambda: kernels.trace_segment(seg)), "bound_ms": bound(*segment_work(seg))[0]})
    rows = {}
    seg = largest["trace_segment"][1]["seg"]
    k, p = seg.fresh(), seg.fresh()
    items = seg.items()
    rows["trace_segment"] = dict(
        shape=f"{len(items)} items in {seg.p1 - seg.p0} phases, {sum(it.rows for it in items)} rows "
              f"({', '.join(f'{it.op} {it.rows}' for it in items[:6])}{', ...' if len(items) > 6 else ''})",
        err=0, ms=time_ms(lambda: kernels.trace_segment(k)), plain_ms=time_ms(lambda: kernels.trace_segment_plain(p)),
        bound=bound(*segment_work(seg)), library=None,
    )
    s = largest["trace_reduce"][1]["s"]
    k, p = s.fresh(), s.fresh()
    rows["trace_reduce"] = dict(
        shape=f"{s.op}, {s.rows * s.dsize} rows, {len(s.cols)} columns, sources {[tuple(v.shape) for _, v in s.srcs]}",
        err=0, ms=time_ms(lambda: kernels.trace_reduce(k)), plain_ms=time_ms(lambda: kernels.trace_reduce_plain(p)),
        bound=step_bound(s), library=None,
    )
    rows["lut_boundary"] = lut_boundary_row(kernels, largest["lut_boundary"][1])
    for name, r in rows.items():
        emit({"phase": "kernel_time", "kernel": name, "shape": r["shape"], "ms": r["ms"],
              "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
              "library_ms": r["library"]})
    return rows


def lut_boundary_row(kernels, a) -> dict:
    """T4 at a LUT boundary of the settings pass, from a fresh staging region,
    beside the composition it replaces (torch.aminmax, stack, cat: the
    library time; tools/kernel_timing.py --kernels T4 times the round
    trips to the host)."""
    src, gathered = a["src"], a["gathered"]
    staging = torch.zeros(kernels.lut_boundary_words(len(src), len(gathered)), dtype=torch.int64, device=src.device)
    return dict(shape=f"{len(src)} int64 source, {len(gathered)} gathered", err=0,
                ms=time_ms(lambda: kernels.lut_boundary(src, gathered, staging)),
                plain_ms=time_ms(lambda: kernels.lut_boundary_plain(src, gathered)),
                bound=bound(*lut_boundary_work(len(src), len(gathered))),
                library=time_ms(lambda: torch.cat([torch.stack(torch.aminmax(src)), gathered])))


def phase_high_security(T, kernels, serde, tracing, tape, f, card, tag, pie, settings, host, expect, k3_limit):
    """The PINN's card PIE and settings proved at PcsConfig.high_security():
    launches of one prove (counters reset just before it), the median of 3,
    the host PIE's proof the same bytes, native/ accepting the proof and
    rejecting it with its nonce plus one, and every kernel call of one more
    prove replayed through kernel and twin.  Returns (launches, {kernel:
    max_abs_err}, kept calls)."""
    import copy

    cfg = T.PcsConfig.high_security()
    host_pie, host_settings = host[:2]
    with tree_bottoms(kernels) as bottoms:
        kernels.reset_counts()
        t0 = time.perf_counter()
        proof = T.prove(pie, settings, cfg)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launches = kernels.counts()
    launches["fri_channel_steps_in_root_passes"] = path_launches(kernels, tag, first_s, launches, bottoms, expect,
                                                                 k3_limit, proof)
    times, phases = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        again = T.prove(pie, settings, cfg)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        phases.append(tracing.last_phases("prove"))
    med = statistics.median(times)
    pb = serde.proof_to_flat_bytes(proof)
    if serde.proof_to_flat_bytes(again) != pb:
        raise AssertionError(f"{tag}: repeated proves of one PIE differ")
    if serde.proof_to_flat_bytes(T.prove(host_pie, host_settings, cfg)) != pb:
        raise AssertionError(f"{tag}: the proof of the host's PIE differs from the proof of the card's")
    verify_s = native_verify(serde, pb, settings, tag)
    bad = copy.deepcopy(proof)
    bad.pcs_proof.pow_nonce += 1
    bad.pcs_proof.fri_proof.pow_nonce = bad.pcs_proof.pow_nonce
    native_verify(serde, serde.proof_to_flat_bytes(bad), settings, tag + "_bad_nonce", expect_accept=False)
    pcs = proof.pcs_proof
    cells = trace_cells(pie)
    emit({
        "phase": "prove", "path": tag, "card": card, "config": proof.config.to_dict(),
        "security_bits": proof.config.security_bits(), "trace_cells": cells, "prove_seconds": times,
        "prove_seconds_median": med, "trace_cells_per_s": cells / med, "phases_s": phases[times.index(med)],
        "proof_bytes": len(pb), "pow_nonce": pcs.pow_nonce, "fri_layers": len(pcs.fri_proof.layer_roots),
        "peak_device_bytes": torch.cuda.max_memory_allocated(), "self_check": "passed",
        "host_pie_proof_equal": True, "native_verify": "accepted", "native_verify_seconds": verify_s,
        "native_rejects_nonce_plus_one": True,
    })
    errs, kept = phase_path_kernels(T, kernels, tape, f, tag, lambda: T.prove(pie, settings, cfg), expect)
    return launches, errs, kept, proof


class twins_refused:
    """While active, every `*_plain` twin (kernels, tape, blake2s) raises:
    a run inside goes through the kernels and host code alone."""

    def __init__(self, kernels, tape):
        from luminair_tpu_torch.crypto import blake2s

        self.saved = [(mod, name, getattr(mod, name)) for mod in (kernels, tape, blake2s) for name in dir(mod)
                      if name.endswith("_plain")]

    @staticmethod
    def _refuse(name):
        def twin(*args, **kwargs):
            raise AssertionError(f"{name} was called")

        return twin

    def __enter__(self):
        for mod, name, _ in self.saved:
            setattr(mod, name, self._refuse(name))
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)
        return False


VERIFY_LAUNCHES = {}  # {path: the cold verify's launches} (phase_verify)
VERIFY_KERNELS = ("circle_fft", "blake2s_merkle")  # the preprocessed recommit's: K1, K2
VERIFY_WARM = 3


def tampered(proof, where: str):
    """A copy of the proof with its PoW nonce plus one, or one byte flipped
    in a value the main tree opens, or in the preprocessed root."""
    import copy

    bad = copy.deepcopy(proof)
    pcs = bad.pcs_proof
    if where == "pow_nonce":
        pcs.pow_nonce += 1
        pcs.fri_proof.pow_nonce = pcs.pow_nonce
    elif where == "tree_value":
        pcs.tree_queried_values[1][0] = pcs.tree_queried_values[1][0].copy()
        pcs.tree_queried_values[1][0].view(np.uint8)[1] ^= 0x01
    else:
        bad.roots[0] = bad.roots[0].copy()
        bad.roots[0].view(np.uint8)[1] ^= 0x01
    return bad


def file_round_trips(T, serde, tag: str, pie, settings, proof, config, shared_from=None) -> dict:
    """The proof through its .npz and JSON files, the settings through
    theirs, the card PIE through its file and a prove on the card: each
    must give the path's flat bytes.  Files under OUT_DIR; a path that
    shares its PIE and settings with the path `shared_from` reads that
    path's PIE and settings files again."""
    from luminair_tpu_torch.air.settings import CircuitSettings

    d = os.path.join(OUT_DIR, f"files_{tag}")
    os.makedirs(d, exist_ok=True)
    pb, sb = serde.proof_to_flat_bytes(proof), serde.settings_to_flat_bytes(settings)
    path = {k: os.path.join(d, k) for k in ("proof.npz", "proof.json")}
    d = os.path.join(OUT_DIR, f"files_{shared_from or tag}")
    path.update({k: os.path.join(d, k) for k in ("settings.json", "settings.bin", "pie.npz")})
    t0 = time.perf_counter()
    serde.proof_to_file(proof, path["proof.npz"])
    serde.proof_to_json_file(proof, path["proof.json"])
    if shared_from is None:
        settings.to_json_file(path["settings.json"])
        settings.to_bin_file(path["settings.bin"])
        serde.pie_to_file(pie, path["pie.npz"])
    write_s = time.perf_counter() - t0
    same = {
        "proof_npz": serde.proof_to_flat_bytes(serde.proof_from_file(path["proof.npz"])) == pb,
        "proof_json": serde.proof_to_flat_bytes(serde.proof_from_json_file(path["proof.json"])) == pb,
        "settings_json": serde.settings_to_flat_bytes(CircuitSettings.from_json_file(path["settings.json"])) == sb,
        "settings_bin": serde.settings_to_flat_bytes(CircuitSettings.from_bin_file(path["settings.bin"])) == sb,
    }
    host_pie = serde.pie_from_file(path["pie.npz"])
    same["pie_proved_on_card"] = serde.proof_to_flat_bytes(
        T.prove(host_pie, CircuitSettings.from_bin_file(path["settings.bin"]), config)) == pb
    if not all(same.values()):
        raise AssertionError(f"{tag}: a file round trip changed the proof or settings bytes: {same}")
    return {"files_equal": same, "files_write_seconds": write_s, "files_shared_from": shared_from,
            "file_bytes": {k: os.path.getsize(v) for k, v in path.items()}}


def phase_verify(T, kernels, serde, tracing, tape, f, card, tag, pie, settings, proof, config=None, expected=None,
                 min_bits: int = 0, shared_from=None):
    """The path's proof verified on the card through the port's entry point.
    The first verify (the preprocessed root's cache cold) with every launch
    counter set to 0 just before it and read just after, and every plain
    twin refused: it must accept, launch K1 and K2 and nothing else, and
    recommit the proof's tree-0 root.  Then the median of VERIFY_WARM warm
    verifies, with their spans; the port and native/ (through the port's
    binding) must reject the proof with its nonce plus one, a byte of a
    main-tree opened value flipped, and a byte of the preprocessed root
    flipped; the files' round trips (file_round_trips); the recommit's kernel calls replayed
    through kernel and twin; one profiled cold verify.  Returns the replay's
    {kernel: max_abs_err}."""
    from luminair_tpu_torch import verifier

    kw = {"expected_config": expected, "min_security_bits": min_bits}
    verifier._PP_ROOT_CACHE.clear()
    with twins_refused(kernels, tape):
        kernels.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ok = T.verify(proof, settings, **kw)
        torch.cuda.synchronize()
        cold_s = time.perf_counter() - t0
        launches = kernels.counts()
    cold_spans = tracing.last_phases("verify")
    launches["fri_channel_steps_in_root_passes"] = kernels.CHANNEL.hosted
    VERIFY_LAUNCHES[tag] = launches
    roots = [r.tolist() for r in verifier._PP_ROOT_CACHE.values()]
    launched = sorted(k for k in VERIFY_KERNELS if launches[k] > 0)
    others = {k: v for k, v in launches.items() if v and k not in VERIFY_KERNELS}
    if ok is not True or launched != sorted(VERIFY_KERNELS) or others or roots != [proof.roots[0].tolist()]:
        raise AssertionError(f"{tag}: the cold verify returned {ok}, launched {launches}, recommitted {roots}")

    warm_s, warm_spans = [], []
    for _ in range(VERIFY_WARM):
        t0 = time.perf_counter()
        T.verify(proof, settings, **kw)
        torch.cuda.synchronize()
        warm_s.append(time.perf_counter() - t0)
        warm_spans.append(tracing.last_phases("verify"))
    med = statistics.median(warm_s)

    rejected = {}
    for where in ("pow_nonce", "tree_value", "root0"):
        bad = tampered(proof, where)
        try:
            T.verify(bad, settings, **kw)
            raise AssertionError(f"{tag}: the port's verify accepted the proof with {where} tampered")
        except T.StwoVerifierError as e:
            rejected[where] = str(e)
        native_verify(serde, serde.proof_to_flat_bytes(bad), settings, f"{tag}_{where}", expect_accept=False)
    native_s = native_verify(serde, serde.proof_to_flat_bytes(proof), settings, tag)
    files = file_round_trips(T, serde, tag, pie, settings, proof, config, shared_from)
    emit({
        "phase": "verify", "path": tag, "card": card, "accepted": True,
        "expected_config": expected.to_dict() if expected is not None else None, "min_security_bits": min_bits,
        "first_verify_seconds": cold_s, "first_verify_spans_s": cold_spans,
        "warm_verify_seconds": warm_s, "warm_verify_seconds_median": med,
        "warm_verify_spans_s": warm_spans[warm_s.index(med)],
        "native_verify_seconds": native_s, "launches": {k: launches[k] for k in VERIFY_KERNELS},
        "recommitted_root_equals_proof": True, "twins_called": 0,
        "port_rejects": rejected, "native_rejects": sorted(rejected), **files,
    })

    def cold_verify():
        verifier._PP_ROOT_CACHE.clear()
        T.verify(proof, settings, **kw)

    errs, kept = phase_path_kernels(T, kernels, tape, f, f"verify_{tag}", cold_verify, VERIFY_KERNELS)
    del kept
    phase_profile(f"verify_{tag}", "verify", cold_verify)
    return errs


LAUNCH_BATCH = 100  # profiled launches of a one-thread or one-CTA launch (launch_device_ms)


def launch_device_ms(launch, name: str) -> float:
    """Device ms of one `launch()`, a single kernel named `name`: the mean of
    its device records over LAUNCH_BATCH launches (a launch from the host
    takes longer than such a kernel, so CUDA events would time the host).
    Fails unless the host's records hold every launch, and the device's at
    least one, with the launches that have none making up the rest."""
    launch()
    p = Profiled(lambda: [launch() for _ in range(LAUNCH_BATCH)], name)
    n = p.count(name)
    if p.host["launches"] != LAUNCH_BATCH or not n or n + len(p.lost) != LAUNCH_BATCH:
        raise AssertionError(f"launch_device_ms: {p.host} and {n} records of {name} for {LAUNCH_BATCH} launches "
                             f"(lost {p.lost})")
    return p.ms(name) / n


def root_pass_ms(kernels, desc, state=None, slot=None) -> float:
    """Device ms of one launch of a tree's root pass (its last, one CTA),
    with K8's step when a state and slot are given."""
    b = kernels.merkle_passes(desc.bottom)[-1]
    ch = (state.data_ptr(), slot.data_ptr()) if state is not None else (0, 0)
    return launch_device_ms(
        lambda: kernels.MERKLE.launch("lum_merkle_pass", desc.words.device, desc.words.data_ptr(), b, *ch),
        "merkle_pass_kernel")


def channel_steps(kernels, kept) -> dict:
    """K8 in a prove whose calls were kept: alpha0's draw (its device ms,
    launch_device_ms) and each FRI layer's step (its tree's root pass with
    the step less without, root_pass_ms), each with its compressions and
    its latency bound, and the twins' ms; largest tree first."""
    draw = next(a for key, a in kept.items() if key[0] == "channel_draw_felt")
    d_state = draw["state"].clone()  # each timed draw goes on from the last
    blocks = _counter(kernels.channel_draw_felt_plain(draw["state"].clone())) - _counter(draw["state"])
    out = {"alpha0": dict(compressions=blocks, device_ms=launch_device_ms(
        lambda: kernels.channel_draw_felt(d_state, draw["out"]), "channel_draw_kernel"),
        bound_ms=bound(*channel_step_work(blocks))[0],
        plain_ms=time_ms(lambda: kernels.channel_draw_felt_plain(draw["state"].clone(), draw["out"].clone()))),
        "steps": []}
    for key, a in kept.items():
        if key[0] != "merkle_tree" or a["state"] is None:
            continue
        desc = kernels.TreeDesc(kernels.tree_layers(a["desc"].bottom, a["state"].device), a["desc"].cols)
        kernels.merkle_tree(desc)
        root = desc.layers[0][0]
        blocks = 1 + int(kernels.channel_mix_root_draw_plain(a["state"].clone(), root)[8])  # the mix and the draw's
        state, slot = a["state"].clone(), torch.zeros(12, dtype=torch.int32, device=a["state"].device)
        with_step, without = root_pass_ms(kernels, desc, state, slot), root_pass_ms(kernels, desc)
        out["steps"].append(dict(
            bottom=desc.bottom, root_pass_bottom=kernels.merkle_passes(desc.bottom)[-1], compressions=blocks,
            with_step_ms=with_step, without_ms=without, device_ms=with_step - without,
            bound_ms=bound(*channel_step_work(blocks))[0],
            plain_ms=time_ms(lambda: kernels.channel_mix_root_draw_plain(state, root, slot))))
    out["steps"].sort(key=lambda st: -st["bottom"])
    return out


def channel_per_prove(tag, ch, records) -> None:
    """K8's device ms per prove (alpha0's launch and every FRI layer's step,
    channel_steps) against its per-prove bound, and K2's profiled device ms
    per prove (`records`, phase_profile) less the steps that ran inside its
    root passes, against K2's per-prove bound."""
    steps_ms = sum(st["device_ms"] for st in ch["steps"])
    k8 = ch["alpha0"]["device_ms"] + steps_ms
    k2 = sum(ms for k, (ms, _) in records.items() if "merkle_pass_kernel" in k)
    b = PER_RUN_BOUND[tag]
    emit({"phase": "fri_channel_per_prove", "path": tag, "alpha0": ch["alpha0"], "steps": ch["steps"],
          "steps_device_ms": steps_ms, "fri_channel_device_ms": k8, "fri_channel_bound_ms": b["fri_channel"],
          "fri_channel_over_bound": k8 / b["fri_channel"], "blake2s_merkle_device_ms_profiled": k2,
          "blake2s_merkle_device_ms_less_steps": k2 - steps_ms, "blake2s_merkle_bound_ms": b["blake2s_merkle"],
          "blake2s_merkle_over_bound": (k2 - steps_ms) / b["blake2s_merkle"]})


def transcript_kernel_rows(kernels, kept, ch) -> dict:
    """K8, K9 and K10 timed at the first call each made in the 80-bit PINN
    prove: K8 as alpha0's launch and the first FRI layer's step (its root
    pass with the step less without; channel_steps), the opening pass
    (decommit_row), the 16-bit search."""
    calls = {}
    for key, a in kept.items():
        name = key[0]
        if name == "decommit":
            if name not in calls or a["plan"].n_words > calls[name][0]:
                calls[name] = (a["plan"].n_words, a)
        elif name == "grind_pow":
            calls.setdefault(name, (0, a))
    rows = {}
    a0, st = ch["alpha0"], ch["steps"][0]
    emit({"phase": "kernel_time_extra", "kernel": "fri_channel", "shape": f"FRI layer 2^{st['bottom']}'s root pass "
          f"(bottom {st['root_pass_bottom']}) and alpha0", "root_pass_device_ms_with_step": st["with_step_ms"],
          "root_pass_device_ms_without_step": st["without_ms"], "step_ms": st["device_ms"],
          "alpha0_device_ms": a0["device_ms"], "blake2s_latency_ms": MEASURED["blake2s_latency_s"] * 1e3})
    rows["fri_channel"] = dict(
        shape=f"alpha0's launch ({a0['compressions']} compression) and the step in the first FRI layer's root pass "
              f"(mix the root, draw alpha: {st['compressions']} compressions), one thread each; device time, the "
              "step's as its root pass with the step less without", err=0, ms=a0["device_ms"] + st["device_ms"],
        plain_ms=a0["plain_ms"] + st["plain_ms"], bound=(a0["bound_ms"] + st["bound_ms"], "operations"),
        library=None,
    )
    rows["decommit"] = decommit_row(kernels, calls["decommit"][1]["plan"])
    a = calls["grind_pow"][1]
    nonce = pow_call_gate(kernels, a["digest"], a["bits"], a["device"])
    rows["grind_pow"] = dict(
        shape=f"{a['bits']} bits, first nonce {nonce}", err=0,
        ms=time_ms(lambda: kernels.grind_pow(a["digest"], a["bits"], a["device"])),
        plain_ms=time_ms(lambda: kernels.grind_pow_plain(a["digest"], a["bits"], a["device"]), reps=3),
        bound=bound(40, (nonce + 1) * OPS_POW_CANDIDATE), library=None,
    )
    for name, r in rows.items():
        emit({"phase": "kernel_time", "kernel": name, "shape": r["shape"], "ms": r["ms"],
              "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
              "library_ms": r["library"]})
    return rows


def pow_call_extra(kernels, kept) -> None:
    """K10 at the PINN's default prove's call (5 bits): its profiled events
    (pow_call_gate) and its call ms."""
    a = next(a for key, a in kept.items() if key[0] == "grind_pow")
    nonce = pow_call_gate(kernels, a["digest"], a["bits"], a["device"])
    emit({"phase": "kernel_time_extra", "kernel": "grind_pow", "shape": f"{a['bits']} bits, first nonce {nonce}",
          "ms": time_ms(lambda: kernels.grind_pow(a["digest"], a["bits"], a["device"])),
          "bound_ms": bound(40, (nonce + 1) * OPS_POW_CANDIDATE)[0]})


def decommit_specs(plan) -> list:
    """The gathers of a decommitment pass as the one-gather-per-spec design
    ran them, (source, positions on the card, axis): per tree the columns
    of each log at its recomputed positions, then per layer the missing
    children's digests (the sets from the plain twin's arithmetic, outside
    any timing)."""
    specs = []
    for tree, qs in zip(plan.trees, plan.queries):
        dev = tree.layers[tree.bottom].device

        def q(log):
            return torch.as_tensor(qs.get(log, np.zeros(0, np.int64)), device=dev)

        comp, values, witness = q(tree.bottom), [], []
        for log in range(tree.bottom, -1, -1):
            if log < tree.bottom:
                new = torch.unique(torch.cat([comp >> 1, q(log)]))
                kids = torch.stack([2 * new, 2 * new + 1], dim=1).reshape(-1)
                missing = kids[~torch.isin(kids, comp)]
                if len(missing):
                    witness.append((tree.layers[log + 1], missing, 0))
                comp = new
            if log in tree.cols and len(comp):
                values.append((tree.cols[log], comp, 1))
        specs += values + witness
    return specs


def decommit_row(kernels, plan) -> dict:
    """K9 at the 80-bit PINN's opening pass.  Timed at the trees' part of
    it (the input trees, the last four), from query positions to the flat
    output: the plan (bounds, checks, packing), one upload, the launch.
    The library time is the composition of one index_select per gather
    (indices already on the card) and one torch.cat; it does none of the
    set arithmetic K9 does.  The whole pass (FRI layers and trees) is
    timed too (kernel_time_extra)."""
    trees = kernels.DecommitPass(plan.trees[-4:], plan.queries[-4:])
    specs = decommit_specs(trees)
    words = sum(int(src.index_select(ax, p).numel()) for src, p, ax in specs)

    def composition():
        return torch.cat([src.index_select(ax, p).reshape(-1) for src, p, ax in specs])

    def call(p):
        return lambda: kernels.decommit(kernels.DecommitPass(p.trees, p.queries))

    fused_words = sum(int(src.index_select(ax, p).numel()) for src, p, ax in decommit_specs(plan))
    fused = bound(8 * len(plan.packed) + 8 * fused_words, 8 * fused_words)
    emit({"phase": "kernel_time_extra", "kernel": "decommit",
          "shape": f"the fused pass: {len(plan.trees)} trees, {fused_words} words", "ms": time_ms(call(plan)),
          "plain_ms": time_ms(lambda: kernels.decommit_plain(plan)), "bound_ms": fused[0], "bound_by": fused[1]})
    return dict(
        shape=f"trees' opening pass: {len(specs)} gathers, {words} words", err=0,
        ms=time_ms(call(trees)), plain_ms=time_ms(lambda: kernels.decommit_plain(trees)),
        bound=bound(8 * len(trees.packed) + 8 * words, 8 * words), library=time_ms(composition),
    )


def phase_op_graphs(T, kernels, serde, tape, f, card):
    """The six op graphs (luminair_tpu_torch/models/op_graphs.py): settings
    and PIE on the card against the host interpreter; every distinct trace
    step replayed through kernel and twin (kernel_check); all_ops proved on
    the card from its card PIE, the same bytes as from its host PIE,
    accepted by the native verifier.  Returns ({kernel: max_abs_err}, the
    all_ops card PIE, settings and proof, {graph: (card PIE, card settings,
    host PIE, host settings)})."""
    from luminair_tpu_torch.graph import trace as host
    from luminair_tpu_torch.models import op_graphs

    twins = trace_twins(kernels)
    kept, calls, graphs = {}, {}, {}
    for name, build in op_graphs.GRAPHS.items():
        def graph():
            cx = T.Graph()
            build(cx, op_graphs.DATA)
            cx.compile()
            return cx

        hcx = graph()
        hs = host.gen_circuit_settings_host(hcx)
        hp = host.gen_trace_host(hcx, hs)
        cx = graph()
        with recording(kernels, twins, kept, calls):
            settings = T.gen_circuit_settings(cx)
            pie = T.gen_trace(cx, settings)
        bad = pie_mismatches(f, pie, hp)
        same_settings = serde.settings_to_flat_bytes(settings) == serde.settings_to_flat_bytes(hs)
        same_out = sorted(cx.output_data) == sorted(hcx.output_data) and all(
            np.array_equal(cx.output_data[k], v) for k, v in hcx.output_data.items())
        line = {"phase": "op_graph", "graph": name, "tables": sorted(pie.trace_tables),
                "pie_equals_host": not bad, "settings_bytes_equal_host": same_settings, "outputs_equal_host": same_out}
        if name == "all_ops":
            all_ops = (pie, settings, T.prove(pie, settings))
            pb = serde.proof_to_flat_bytes(all_ops[2])
            line["host_pie_proof_equal"] = pb == serde.proof_to_flat_bytes(T.prove(hp, hs))
            line["native_verify_seconds"] = native_verify(serde, pb, settings, "all_ops")
        emit(line)
        if bad or not same_settings or not same_out or not line.get("host_pie_proof_equal", True):
            raise AssertionError(f"op graph {name}: the card's trace differs from the host's: {bad[:8]}")
        graphs[name] = (pie, settings, hp, hs)
    by_kernel = replay(kernels, twins, kept, calls)
    errs = {}
    for kernel_name in twins:
        row = by_kernel[kernel_name]
        emit({"phase": "kernel_check", "kernel": kernel_name, "graphs": "op_graphs", "calls": row["calls"],
              "shapes": len(row["shapes"]), "max_abs_err": row["max_abs_err"]})
        if row["max_abs_err"] != 0 or not row["shapes"]:
            raise AssertionError(f"{kernel_name}: disagrees with its twin on the op graphs, or never ran")
        errs[kernel_name] = row["max_abs_err"]
    return errs, all_ops, graphs


# Log blowups every op graph is proved at (phase_op_graph_blowups).  The
# port's CPU proof of the host PIE is compared where it is cheap: all six
# graphs at blowups 1-2 and the four small ones at 3-4; all_ops and mlp,
# whose sin / exp2 tables take 2^14 rows, prove in 8-22 s each on one CPU
# thread at 3-4 and are left out there.
OP_GRAPH_BLOWUPS = (1, 2, 3, 4)
OP_GRAPH_CPU_SKIPPED = (("all_ops", 3), ("all_ops", 4), ("mlp", 3), ("mlp", 4))


def phase_op_graph_blowups(T, serde, card, graphs):
    """Each op graph proved from its card PIE at every log blowup of
    OP_GRAPH_BLOWUPS: the same bytes as the card's proof of the host
    interpreter's PIE and, but for OP_GRAPH_CPU_SKIPPED, as the port's CPU
    proof; the port's verify (on the card) and native/ accept it."""
    t_phase = time.perf_counter()
    for name, (pie, settings, hp, hs) in graphs.items():
        for b in OP_GRAPH_BLOWUPS:
            cfg = T.PcsConfig(fri=T.FriConfig(log_blowup_factor=b))
            t0 = time.perf_counter()
            proof = T.prove(pie, settings, cfg)
            prove_s = time.perf_counter() - t0
            pb = serde.proof_to_flat_bytes(proof)
            line = {"phase": "op_graph_blowup", "graph": name, "log_blowup": b, "card": card,
                    "prove_seconds": prove_s, "proof_bytes": len(pb),
                    "host_pie_proof_equal": serde.proof_to_flat_bytes(T.prove(hp, hs, cfg)) == pb}
            if (name, b) in OP_GRAPH_CPU_SKIPPED:
                line["cpu_proof_equal"] = "skipped"
            else:
                t0 = time.perf_counter()
                line["cpu_proof_equal"] = serde.proof_to_flat_bytes(T.prove(hp, hs, cfg, device="cpu")) == pb
                line["cpu_prove_seconds"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            line["verified"] = T.verify(proof, settings) is True
            line["verify_seconds"] = time.perf_counter() - t0
            line["native_verify_seconds"] = native_verify(serde, pb, settings, f"{name}_b{b}")
            emit(line)
            if not line["host_pie_proof_equal"] or line["cpu_proof_equal"] is False or not line["verified"]:
                raise AssertionError(f"{name} at log blowup {b}: {line}")
    emit({"phase": "op_graph_blowups", "seconds": time.perf_counter() - t_phase, "graphs": len(graphs),
          "blowups": list(OP_GRAPH_BLOWUPS), "cpu_skipped": [list(x) for x in OP_GRAPH_CPU_SKIPPED]})


def phase_pinn_blowup(T, kernels, serde, card, tag, pie, settings, host, expect, peak_b1):
    """The PINN's card PIE and settings proved at log blowup 2 (commit
    domains up to 2^23, the composition's working domain 2^24): launches
    of the first prove with the counters reset just before it (path line),
    the median of 3, the host PIE's proof the same bytes, native/ accepting
    it, and the peak device memory since a reset beside blowup 1's."""
    t_phase = time.perf_counter()
    cfg = T.PcsConfig(fri=T.FriConfig(log_blowup_factor=2))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with tree_bottoms(kernels) as bottoms:
        kernels.reset_counts()
        t0 = time.perf_counter()
        proof = T.prove(pie, settings, cfg)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launches = kernels.counts()
    k3_limit = 1 + len(proof.pcs_proof.fri_proof.layer_roots)
    launches["fri_channel_steps_in_root_passes"] = path_launches(kernels, tag, first_s, launches, bottoms, expect,
                                                                 k3_limit, proof)
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        again = T.prove(pie, settings, cfg)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    pb = serde.proof_to_flat_bytes(proof)
    if serde.proof_to_flat_bytes(again) != pb:
        raise AssertionError(f"{tag}: repeated proves of one PIE differ")
    if serde.proof_to_flat_bytes(T.prove(host[0], host[1], cfg)) != pb:
        raise AssertionError(f"{tag}: the proof of the host's PIE differs from the proof of the card's")
    verify_s = native_verify(serde, pb, settings, tag)
    emit({
        "phase": "prove", "path": tag, "card": card, "config": proof.config.to_dict(),
        "trace_cells": trace_cells(pie), "prove_seconds": times, "prove_seconds_median": statistics.median(times),
        "proof_bytes": len(pb), "fri_layers": len(proof.pcs_proof.fri_proof.layer_roots),
        "peak_device_bytes": peak, "peak_device_bytes_blowup_1": peak_b1, "self_check": "passed",
        "host_pie_proof_equal": True, "native_verify": "accepted", "native_verify_seconds": verify_s,
        "phase_seconds": time.perf_counter() - t_phase,
    })
    return launches


DEBUG_KERNELS = ("air_witness", "air_check")  # check_pie_constraints: K5 and the check
DEBUG_WARM = 3
# Cells changed in the op graphs' card PIEs (graph, table, column, row): the
# port's check on the card must give the same dict as on the CPU.
DEBUG_MUTATIONS = (
    ("all_ops", "mul", "out", 3), ("all_ops", "mul", "lhs", 0), ("all_ops", "add", "out", 7),
    ("all_ops", "mul", "out_mult", 0), ("all_ops", "sin_lookup", "multiplicity", 5),
    ("all_ops", "less_than", "diff", 1), ("all_ops", "rem", "rem", 2), ("all_ops", "max_reduce", "is_max", 0),
    ("negative", "sqrt", "rem", 4), ("reduce_axes", "sum_reduce", "acc", 1), ("mlp", "sum_reduce", "input", 9),
    ("slices", "contiguous", "out", 2),
)


def debug_twins(kernels):
    return {"air_check_many": ("air_check", lambda a: kernels.air_check_many_plain(a["comps"], a["ew"]), ())}


def host_form(pie):
    """A card PIE's host form: its columns downloaded as uint32 words."""
    from luminair_tpu_torch.air.pie import LuminairPie, TraceTable

    return LuminairPie({k: TraceTable(k, t.host_columns()) for k, t in pie.trace_tables.items()}, pie.metadata)


def mutate_cell(f, pie, table: str, column: str, row: int) -> int:
    """Adds 1 (mod P) to one cell of a card PIE in place; returns the old
    word."""
    col = pie.trace_tables[table].padded[column]
    old = int(col[row])
    col[row] = (old + 1) % f.P
    return old


def phase_debug_pinn(T, kernels, tape, f, card, tag, pie, settings):
    """check_pie_constraints on the PINN's card PIE: the first call (cold)
    with every launch counter set to 0 just before it and read just after
    (K5 and air_check only, each exactly once: every component in one
    launch; an empty result), DEBUG_WARM more; then one run with every
    air_check call kept, and mul.out changed at row 3 (the check must name
    constraint 1 of mul at row 3 alone); each kept call through kernel and
    twin; the honest run's check launch timed beside its twin and bound.
    Returns (launches, {kernel: max_abs_err})."""
    from luminair_tpu_torch.air.debug import check_pie_constraints

    t_phase = time.perf_counter()
    kernels.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = check_pie_constraints(pie, settings)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    launches = kernels.counts()
    launched = sorted(k for k, v in launches.items() if v)
    launches["fri_channel_steps_in_root_passes"] = kernels.CHANNEL.hosted
    if (got != {} or launched != sorted(DEBUG_KERNELS) or launches["air_check"] != 1 or launches["air_witness"] != 1
            or kernels.CHANNEL.hosted):
        raise AssertionError(f"{tag}: check_pie_constraints returned {got}, launched {launches}")
    warm_s = []
    for _ in range(DEBUG_WARM):
        t0 = time.perf_counter()
        check_pie_constraints(pie, settings)
        torch.cuda.synchronize()
        warm_s.append(time.perf_counter() - t0)
    twins, kept, calls = debug_twins(kernels), {}, {}
    with recording(kernels, twins, kept, calls) as rec:
        check_pie_constraints(pie, settings)
    old = mutate_cell(f, pie, "mul", "out", 3)
    with recording(kernels, twins, kept, calls):
        mutated = check_pie_constraints(pie, settings)
    pie.trace_tables["mul"].padded["out"][3] = old
    row = replay(kernels, twins, kept, calls)["air_check"]
    whole = kept[("air_check_many", 1)]
    b = bound(*check_many_work(whole))
    emit({"phase": "kernel_time_extra", "kernel": "air_check", "path": tag,
          "shape": f"the check's one launch: {len(whole['comps'])} components, "
                   f"{sum(c[4].shape[0] for c in whole['comps'])} rows",
          "ms": time_ms(lambda: kernels.air_check_many(whole["comps"], whole["ew"])),
          "plain_ms": time_ms(lambda: kernels.air_check_many_plain(whole["comps"], whole["ew"])),
          "bound_ms": b[0], "bound_by": b[1]})
    del kept, whole
    phase_profile(tag, "check", lambda: check_pie_constraints(pie, settings))
    emit({"phase": "debug", "path": tag, "card": card, "result": got, "first_seconds": cold_s, "warm_seconds": warm_s,
          "warm_seconds_median": statistics.median(warm_s), "launches": {k: launches[k] for k in DEBUG_KERNELS},
          "air_check_bound_ms": rec.bound_ms.get("air_check"), "air_check_calls": rec.bound_calls.get("air_check"),
          "mutated_mul_out_row_3": {k: [list(x) for x in v] for k, v in mutated.items()},
          "phase_seconds": time.perf_counter() - t_phase})
    emit({"phase": "kernel_check", "kernel": "air_check", "path": tag, "calls": row["calls"],
          "shapes": len(row["shapes"]), "max_abs_err": row["max_abs_err"]})
    if mutated != {"mul": [(1, [3])]} or row["max_abs_err"] != 0 or not row["shapes"]:
        raise AssertionError(f"{tag}: the check found {mutated} for mul.out at row 3, air_check {row}")
    return launches, {"air_check": row["max_abs_err"]}


def bits_of(words: torch.Tensor) -> int:
    """The OR of a tensor's int32 words, as an unsigned int."""
    out = 0
    for v in words.unique().tolist():
        out |= v & 0xFFFFFFFF
    return out


def every_component_check(kernels, tape, f, dev, logs: dict, what: str) -> int:
    """air_check_many over every compiled component in one launch, each at
    2^logs[name] rows, on random words and on small words (0-2) with
    their honest interaction (K5's twin), is_first the trace domain's,
    against air_check_many_plain at max_abs_err 0 (outside any counted
    run).  Random words must set every constraint's bit somewhere in the
    twin's words, so that a bit the kernel drops shows.  Returns the
    max_abs_err."""
    from luminair_tpu_torch.air.components import ALL_COMPONENTS

    rng = np.random.default_rng(15)
    ew = [[tuple(int(x) for x in rng.integers(0, f.P, 4)) for _ in range(2)] for _ in tape.ELEM_KINDS]
    err = 0
    for fill in ("random", "honest"):
        comps = []
        for comp in ALL_COMPONENTS:
            n, tp = 1 << logs[comp.name], tape.record(comp)

            def col():
                return torch.from_numpy(rng.integers(0, 3 if fill == "honest" else f.P, n).astype(np.int32)).to(dev)

            main, pp = [col() for _ in comp.MAIN], [col() for _ in comp.PP_IDS]
            is_first = torch.zeros(n, dtype=torch.int32, device=dev)
            is_first[0] = 1
            if fill == "honest":
                inter, claimed = tape.witness_plain(tape.record(comp, witness=True), main, pp, ew)
                comps.append((tp, main, pp, list(inter.unbind(0)), is_first, tuple(int(x) for x in claimed.cpu())))
            else:
                comps.append((tp, main, pp, [col() for _ in range(4 * tp.n_relations)], is_first,
                              tuple(int(x) for x in rng.integers(0, f.P, 4))))
        got, want = kernels.air_check_many(comps, ew), kernels.air_check_many_plain(comps, ew)
        torch.cuda.synchronize()
        e = max_abs_err(got, want)
        parts = zip(comps, got.split([c[4].shape[0] for c in comps]), want.split([c[4].shape[0] for c in comps]))
        differ, unset = {}, []
        for (tp, *_), g, w in parts:
            x = g ^ w
            if x.any():
                differ[tp.name] = {"rows": int((x != 0).sum()), "bits": hex(bits_of(x))}
            seen = bits_of(w)
            if fill == "random" and seen != (1 << tp.n_pows) - 1:
                unset.append(tp.name)
        emit({"phase": "kernel_check", "kernel": "air_check", "check": f"every component, {what}, {fill} words",
              "components": len(comps), "rows": {c[0].name: c[4].shape[0] for c in comps}, "max_abs_err": e,
              "components_that_differ": differ, "random_words_leave_bits_unset": unset})
        if e != 0 or unset:
            raise AssertionError(f"air_check over every component ({what}, {fill} words) disagrees with its twin "
                                 f"in {sorted(differ)}, or its twin leaves bits unset in {unset}")
        err = max(err, e)
        del comps, got, want
    return err


def every_component_air(kernels, tape, f, dev, logs: dict, what: str) -> dict:
    """K5 and K6 over every compiled component, one launch each (outside
    any counted run): each component at 2^logs[name] trace rows, K6 on its
    commit domain at blowup 1 (the components of one trace log in one
    block, the alpha powers running on), on random words and on small
    words (0-2) with their honest interaction (K5's twin), against the
    twins at max_abs_err 0.  Then the largest trace's components as 4 row
    blocks: K5 of the blocks with their carries in one launch, K6 of the
    domain's blocks with their halos, a launch a block.  Returns {kernel:
    max_abs_err}."""
    from luminair_tpu_torch.air.components import ALL_COMPONENTS

    rng = np.random.default_rng(17)
    ew = [[tuple(int(x) for x in rng.integers(0, f.P, 4)) for _ in range(2)] for _ in tape.ELEM_KINDS]
    errs = {"air_witness": 0, "air_domain": 0}
    for fill in ("random", "honest"):
        def col(n):
            return torch.from_numpy(rng.integers(0, 3 if fill == "honest" else f.P, n).astype(np.int32)).to(dev)

        comps, by_log = [], {}
        start, alpha = [tuple(int(x) for x in rng.integers(0, f.P, 4)) for _ in range(2)]
        for comp in ALL_COMPONENTS:
            n = logs[comp.name]
            tpw, tpd = tape.record(comp, witness=True), tape.record(comp)
            comps.append((tpw, [col(1 << n) for _ in comp.MAIN], [col(1 << n) for _ in comp.PP_IDS]))
            m = 1 << (n + 1)
            main, pp = [col(m) for _ in comp.MAIN], [col(m) for _ in comp.PP_IDS]
            if fill == "honest":
                inter, claimed = tape.witness_plain(tpw, main, pp, ew)
                inter, claimed = [c.contiguous() for c in inter.unbind(0)], tuple(int(x) for x in claimed.cpu())
                is_first = torch.zeros(m, dtype=torch.int32, device=dev)
                is_first[0] = 1
            else:
                inter, is_first = [col(m) for _ in range(4 * tpd.n_relations)], col(m)
                claimed = tuple(int(x) for x in rng.integers(0, f.P, 4))
            pows, start = f.qm31_powers_ints(start, alpha, tpd.n_pows)
            by_log.setdefault(n, []).append(kernels.DomainTerm(tpd, main, pp, inter, is_first, claimed, pows))
        outs, claimed = kernels.air_witness_many(comps, ew)
        want, want_claimed = kernels.air_witness_many_plain(comps, ew)
        e5 = max([max_abs_err(g, w) for g, w in zip(outs, want)] + [max_abs_err(claimed, want_claimed)])
        blocks = [kernels.DomainBlock(terms, n, 2) for n, terms in sorted(by_log.items())]
        got6, want6 = kernels.air_domain_many(blocks, ew), kernels.air_domain_many_plain(blocks, ew)
        e6 = max(max_abs_err(g, w) for g, w in zip(got6, want6))
        # The largest trace in 4 row blocks: K5 with each block's carry, K6 with each block's halo.
        big = max(by_log)
        parts, R = [], (1 << big) // 4
        for (tpw, main, pp), w in zip(comps, want):
            if main and main[0].shape[0] == 1 << big:
                for r in range(4):
                    carry = w[-4:, r * R - 1].contiguous() if r else torch.zeros(4, dtype=torch.int32, device=dev)
                    parts.append(((tpw, [c[r * R : (r + 1) * R] for c in main],
                                   [c[r * R : (r + 1) * R] for c in pp], carry), w[:, r * R : (r + 1) * R]))
        e5b = max(max_abs_err(g, w) for g, (_, w) in zip(kernels.air_witness_many([p for p, _ in parts], ew)[0],
                                                            parts))
        blk, M = blocks[-1], blocks[-1].rows
        S = M // 4
        e6b = 0
        for r in range(4):
            nxt0, prev0 = ((r + 1) % 4) * S, (r * S - blk.stride) % M
            terms = [kernels.DomainTerm(t.tp, [c[r * S : (r + 1) * S] for c in t.main],
                                        [c[r * S : (r + 1) * S] for c in t.pp], [c[r * S : (r + 1) * S] for c in t.inter],
                                        t.is_first[r * S : (r + 1) * S], t.claimed, t.pows,
                                        ({x: t.main[x][nxt0 : nxt0 + blk.stride] for x in t.tp.next_cols},
                                         [c[prev0 : prev0 + blk.stride] for c in t.inter[-4:]])) for t in blk.terms]
            got = kernels.air_domain_many([kernels.DomainBlock(terms, blk.log_trace, blk.stride, r * S, big + 1)],
                                          ew)[0]
            e6b = max(e6b, max_abs_err(got, want6[-1][r * S : (r + 1) * S]))
        torch.cuda.synchronize()
        emit({"phase": "kernel_check", "kernel": "air_witness, air_domain",
              "check": f"every component in one launch, {what}, {fill} words", "trace_logs": logs,
              "air_witness_max_abs_err": e5, "air_domain_max_abs_err": e6,
              "row_blocks": f"{len(parts)} blocks of 2^{big - 2} rows with carries (K5), 4 blocks of the 2^{big + 1}"
                            f"-row domain of {len(blk.terms)} components with halos (K6)",
              "air_witness_row_blocks_max_abs_err": e5b, "air_domain_row_blocks_max_abs_err": e6b})
        if e5 or e6 or e5b or e6b:
            raise AssertionError(f"K5 or K6 over every component ({what}, {fill} words) disagrees with its twin")
        errs["air_witness"] = max(errs["air_witness"], e5, e5b)
        errs["air_domain"] = max(errs["air_domain"], e6, e6b)
        del comps, by_log, blocks, got6, want6, outs, want, parts
        torch.cuda.empty_cache()
    return errs


def phase_debug_graphs(T, kernels, tape, f, card, graphs, pinn_logs):
    """check_pie_constraints on each op graph's card PIE (empty), and on the
    card PIEs of DEBUG_MUTATIONS against the port's check on the CPU of
    the same PIE's host form; every air_check call through kernel and twin.
    Then `every_component_check` and `every_component_air` at the op
    graphs' row counts (each component at its largest table among them)
    and at the PINN's (its components at theirs, the rest at the op
    graphs').  Returns {kernel: max_abs_err}."""
    from luminair_tpu_torch.air.debug import check_pie_constraints

    t0 = time.perf_counter()
    twins, kept, calls = debug_twins(kernels), {}, {}
    found = {}
    with recording(kernels, twins, kept, calls):
        for name, (pie, settings, _, _) in graphs.items():
            got = check_pie_constraints(pie, settings)
            if got != {}:
                raise AssertionError(f"op graph {name}: the check found {got} in an honest PIE")
        for name, table, column, row in DEBUG_MUTATIONS:
            pie, settings = graphs[name][:2]
            old = mutate_cell(f, pie, table, column, row)
            got = check_pie_constraints(pie, settings)
            want = check_pie_constraints(host_form(pie), settings, device="cpu")
            pie.trace_tables[table].padded[column][row] = old
            found[f"{name}.{table}.{column}[{row}]"] = {k: [list(x) for x in v] for k, v in got.items()}
            if got != want:
                raise AssertionError(f"{name}: {table}.{column} at row {row}: the card found {got}, the CPU {want}")
    row = replay(kernels, twins, kept, calls)["air_check"]
    emit({"phase": "debug", "path": "op_graphs", "card": card, "honest_graphs": sorted(graphs),
          "mutations_equal_cpu": found, "seconds": time.perf_counter() - t0})
    emit({"phase": "kernel_check", "kernel": "air_check", "graphs": "op_graphs", "calls": row["calls"],
          "shapes": len(row["shapes"]), "max_abs_err": row["max_abs_err"]})
    if row["max_abs_err"] != 0 or not row["shapes"]:
        raise AssertionError(f"air_check disagrees with its twin on the op graphs, or never ran: {row}")
    from luminair_tpu_torch.air.components import ALL_COMPONENTS

    tables = [t for pie, *_ in graphs.values() for t in pie.trace_tables.values() if t.n_rows]
    smallest = min(t.log_size for t in tables)
    graph_logs = {c.name: max([t.log_size for t in tables if t.name == c.name], default=smallest)
                  for c in ALL_COMPONENTS}
    dev = torch.device("cuda", 0)
    err = max(row["max_abs_err"], every_component_check(kernels, tape, f, dev, graph_logs, "op graphs' rows"),
              every_component_check(kernels, tape, f, dev, {**graph_logs, **pinn_logs}, "the PINN's rows"))
    air = [every_component_air(kernels, tape, f, dev, {k: max(v, 1) for k, v in logs.items()}, what)
           for logs, what in ((graph_logs, "op graphs' rows"), ({**graph_logs, **pinn_logs}, "the PINN's rows"))]
    return {"air_check": err, **{k: max(e[k] for e in air) for k in air[0]}}


EXAMPLES = ("torch_simple", "torch_risk_assessment", "torch_black_scholes_nn")
# Every example settles, traces, proves and verifies on the card.
EXAMPLE_KERNELS = ("circle_fft", "blake2s_merkle", "fri_layer", "deep_quotient", "air_witness", "air_domain",
                   "oods_eval", "fri_channel", "decommit", "grind_pow", "trace_segment")


def example_module(name: str):
    """examples/<name>.py, loaded from its file (the examples are scripts)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(f"chip_smoke_{name}", os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def files_digest(d: str) -> dict:
    import hashlib

    return {n: hashlib.sha256(open(os.path.join(d, n), "rb").read()).hexdigest() for n in sorted(os.listdir(d))}


def phase_examples(kernels, card):
    """Each port example's main() on the card, its launches counted from a
    reset just before it: it must pass its own assertions and launch every
    kernel of EXAMPLE_KERNELS; the reference's examples/out/ keeps its
    bytes."""
    t_phase = time.perf_counter()
    out_dir = os.path.join(ROOT, "examples", "out")
    before = files_digest(out_dir) if os.path.isdir(out_dir) else None
    for name in EXAMPLES:
        mod = example_module(name)
        kernels.reset_counts()
        t0 = time.perf_counter()
        r = mod.main()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = kernels.counts()
        line = {"phase": "example", "example": name, "card": card, "printed": r["printed"], "seconds": wall_s,
                "launches": {k: v for k, v in launches.items() if v}}
        for k in ("prove_seconds", "verify_seconds", "native_verify_seconds", "seconds"):
            if k in r:
                line[k if k != "seconds" else "stage_seconds"] = r[k]
        if name == "torch_simple":
            line["output_expected"] = r["output"] == [[11.0, 42.0], [93.0, 164.0]]
        emit(line)
        missing = [k for k in EXAMPLE_KERNELS if launches[k] == 0]
        if missing or launches["air_check"] or not line.get("output_expected", True):
            raise AssertionError(f"{name}: launched no {missing}, or air_check, or a wrong output: {line}")
    if before is not None and files_digest(out_dir) != before:
        raise AssertionError("examples/out/ changed")
    emit({"phase": "examples", "seconds": time.perf_counter() - t_phase, "examples_out_unchanged": before is not None})


def phase_profile(tag: str, what: str, run):
    """One call of `run` (a prove, or the card's settings and trace) under
    torch.profiler: the device's busy time (the sum of kernel times; one
    stream, so kernels do not overlap), its idle share of the profiled wall
    time, the host-to-device copies, and the kernels that take the most
    device time (the profiler's own cost lengthens the wall time, so the
    idle share is an upper estimate)."""
    p = Profiled(run)
    records, wall_ms = p.device, p.wall_ms
    rows = sorted(((k, ms, c) for k, (ms, c) in records.items() if ms > 0), key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    htod = [(ms, c) for k, ms, c in rows if "Memcpy HtoD" in k]
    dtoh = [(ms, c) for k, ms, c in rows if "Memcpy DtoH" in k]
    emit({
        "phase": "profile", "path": tag, "run": what, "wall_ms_profiled": wall_ms, "host_records": p.host,
        "without_a_device_record": p.lost, "device_lead_us": p.device_lead_us,
        "warm_up_recorded": p.warm_up_recorded,
        "device_busy_ms": busy_ms if rows else "not measured",
        "device_idle_share": 1 - busy_ms / wall_ms if rows else "not measured",
        "device_kernels": len(rows),
        "memcpy_htod": {"ms": sum(ms for ms, _ in htod), "count": sum(c for _, c in htod)},
        "memcpy_dtoh": {"ms": sum(ms for ms, _ in dtoh), "count": sum(c for _, c in dtoh)},
        "port_kernels": {
            name: {"ms": sum(ms for k, ms, _ in rows if name in k),
                   "count": sum(c for k, _, c in rows if name in k)}
            for name in PORT_KERNEL_NAMES
        },
        "top": [{"name": k[:90], "ms": ms, "count": c} for k, ms, c in rows[:15]],
    })
    return records


def phase_parity(T, serde):
    """The N=16 graph traced and proved on the card, and traced and proved
    on the CPU: the same proof bytes, at the default profile and at
    high_security()."""
    for name, cfg in (("default", None), ("high_security", T.PcsConfig.high_security())):
        proofs = []
        for device in ("cuda", "cpu"):
            cx, _ = bench_graph(T, N_PARITY)
            settings = T.gen_circuit_settings(cx, device=device)
            proofs.append(serde.proof_to_flat_bytes(T.prove(T.gen_trace(cx, settings, device=device), settings,
                                                            cfg, device=device)))
        if proofs[0] != proofs[1]:
            raise AssertionError(f"N={N_PARITY}, {name}: GPU proof bytes differ from CPU proof bytes")
        emit({"phase": "gpu_vs_cpu", "n": N_PARITY, "config": name, "proof_bytes": len(proofs[0]), "equal": True})



# --- several devices (luminair_tpu_torch/parallel/sharding.py) -------------

MESH_KINDS = ("1", "2", "4", "rows_cols_2x2")  # prover_step's meshes, all on the card
# prover_step's shapes (columns, log rows), 2 relation columns: the
# reference test's, and the PINN's `mul` table (16 columns, 2^21 rows).
MESH_STEP_SHAPES = {"reference": (8, 5), "full_width": (16, 21)}
MESH_REL_COLS = 2
MESH_PROVE_SHARDS = (2, 4)
# K1, K2, K7, K9, and since the AIR and FRI phases run on row shards K3-K6
# and K5's carry pass.
MESH_PROVE_KERNELS = ("circle_fft", "blake2s_merkle", "oods_eval", "decommit", "fri_layer", "deep_quotient",
                      "air_witness", "add_carry", "air_domain")
# Every row shard launches these (K7 runs where the coefficients lie), and
# every row shard but the first the carry pass.
MESH_ROW_KERNELS = ("circle_fft", "blake2s_merkle", "fri_layer", "deep_quotient", "air_witness", "air_domain")
# The wrappers of the row-shard modes (phase mesh_kernels): K3 on mirror-
# assembled blocks, K4's plan of a row shard, K5 on a row block, the carry
# pass, K6 on a row block with its halo; the PINN proved at log blowups 1
# and 2 (K6's strides 2 and 4) over MESH_KERNEL_SHARDS shards of the card.
MESH_KERNEL_TWINS = ("fri_layer", "deep_quotient_many", "air_witness_many", "add_carry", "air_domain_many")
MESH_KERNEL_SHARDS = 4
MESH_KERNEL_BLOWUPS = (1, 2)
# The PINN's bytes gathered onto the lead over 4 shards when the AIR and
# FRI phases still ran on the lead (NVIDIA H100 80GB HBM3, 700.00 W;
# PERF.md section 6).
PARENT_PINN_GATHERED_4 = 852_230_144


def logup_work(k: int, n: int):
    """(bytes, operations) of one logup_sum call over n rows of k relation
    columns: the k columns and the multiplicities read once, 4 words
    written; a row's k QM31-by-M31 products and subtractions, a QM31
    inverse, a product by the multiplicity and an add; the k - 1 alpha
    powers once."""
    row = k * (4 * OPS_MUL + 4 * OPS_ADD) + OPS_QINV + 4 * OPS_MUL + 4 * OPS_ADD
    return 4 * (k + 1) * n + 16, n * row + max(k - 1, 0) * OPS_QMUL


def step_inputs(n_cols: int, log_n: int):
    """prover_step's inputs as the reference's test draws them."""
    rng = np.random.default_rng(7 + log_n)
    cols = rng.integers(0, (1 << 31) - 1, size=(n_cols, 1 << log_n), dtype=np.uint32)
    mult = rng.integers(0, (1 << 31) - 1, size=(1 << log_n,), dtype=np.uint32)
    z = rng.integers(1, (1 << 31) - 1, size=(4,), dtype=np.uint32)
    alpha = rng.integers(1, (1 << 31) - 1, size=(4,), dtype=np.uint32)
    return cols, mult, z, alpha


def mesh_of(S, kind: str, devices):
    if kind == "rows_cols_2x2":
        return S.make_mesh(4, (2, 2), devices=devices[:4])
    return S.make_chip_mesh(int(kind), devices=devices[: int(kind)])


def phase_logup_kernel(kernels, f, dev) -> dict:
    """logup_sum against its twin on the card at prover_step's two shapes
    (the relation columns of each), timed at full width beside its twin
    and its bound: the kernels line's row."""
    row = {"err": 0}
    for name, (n_cols, log) in MESH_STEP_SHAPES.items():
        cols, mult, z, alpha = step_inputs(n_cols, log)
        values = f.u32_to_tensor(cols[:MESH_REL_COLS], dev)
        m = f.u32_to_tensor(mult, dev)
        err = max_abs_err(kernels.logup_sum(values, m, z, alpha), kernels.logup_sum_plain(values, m, z, alpha))
        emit({"phase": "kernel_check", "kernel": "logup_sum", "shape": [MESH_REL_COLS, 1 << log], "max_abs_err": err})
        row["err"] = max(row["err"], err)
        if name == "full_width":
            row["ms"] = time_ms(lambda: kernels.logup_sum(values, m, z, alpha))
            row["plain_ms"] = time_ms(lambda: kernels.logup_sum_plain(values, m, z, alpha), reps=3)
            row["bound"] = bound(*logup_work(MESH_REL_COLS, 1 << log))
            row["shape"] = [MESH_REL_COLS, 1 << log]
    emit({"phase": "kernel_time", "kernel": "logup_sum", "shape": row["shape"], "ms": row["ms"],
          "plain_ms": row["plain_ms"], "bound_ms": row["bound"][0], "bound_by": row["bound"][1]})
    if row["err"]:
        raise AssertionError(f"logup_sum disagrees with its twin: {row['err']}")
    return row


def phase_logup_plan(S, kernels, f, dev, card, row: dict) -> None:
    """logup_sum through a plan built once (kernels.LogupPlan), as
    prover_step calls it: the planned call at both shapes of
    phase_logup_kernel against the twin; at full width one plan on the
    four quarters of the rows (four virtual shards, each into its row of
    one result) in turns with a second plan of another z and alpha, each
    call against the twin; the planned call timed beside its bound (the
    kernels line's ms; `row`, phase_logup_kernel's, keeps the one-off
    call's as `call_ms`); the lead's adds of a 4-shard prover_step's LogUp
    part (sharding._logup_sum_body) at full width, counted from the host's
    records of one profiled call: gated to 1."""
    err = reused = 0
    for n_cols, log in MESH_STEP_SHAPES.values():
        cols, mult, z, alpha = step_inputs(n_cols, log)
        values, m = f.u32_to_tensor(cols[:MESH_REL_COLS], dev), f.u32_to_tensor(mult, dev)
        plan = kernels.LogupPlan(z, alpha, MESH_REL_COLS)
        err = max(err, max_abs_err(plan(values, m), kernels.logup_sum_plain(values, m, z, alpha)))
    z2, alpha2 = np.random.default_rng(99).integers(1, (1 << 31) - 1, size=(2, 4), dtype=np.uint32)
    plans = [(plan, z, alpha), (kernels.LogupPlan(z2, alpha2, MESH_REL_COLS), z2, alpha2)]
    q = values.shape[1] // 4
    out = torch.empty((4, 4), dtype=f.I32, device=dev)
    for r in range(4):
        v, mr = values[:, r * q : (r + 1) * q], m[r * q : (r + 1) * q]
        for p, zz, aa in plans:
            p(v, mr, out[r])
            reused = max(reused, max_abs_err(out[r], kernels.logup_sum_plain(v, mr, zz, aa)))
    ms = time_ms(lambda: plan(values, m))
    mesh = S.make_chip_mesh(4, devices=[dev] * 4)
    body = Profiled(lambda: S._logup_sum_body(mesh, cols[:MESH_REL_COLS], mult, z, alpha), need="logup_sum")
    adds = body.op_count("aten::add", "aten::add_", "aten::sum")
    emit({"phase": "logup_plan", "card": card, "shape": [MESH_REL_COLS, values.shape[1]], "max_abs_err": err,
          "reused_max_abs_err": reused, "planned_call_ms": ms, "call_ms": row["ms"], "bound_ms": row["bound"][0],
          "bound_by": row["bound"][1], "share_of_bound": row["bound"][0] / ms, "lead_adds_4_shards": adds,
          "logup_launches_4_shards": body.count("logup_sum")})
    if err or reused or adds != 1:
        raise AssertionError(f"logup_plan: max_abs_err {err}, reused plans {reused}, lead adds {adds} (1 planned)")
    row.update(call_ms=row["ms"], ms=ms)


TRAIN_STEPS = 3000  # the training script's default
TRAIN_CHECK_STEPS = 50  # the card's and the CPU's runs compared
TRAIN_RTOL = 1e-3  # the loss after TRAIN_CHECK_STEPS, card against CPU (float32 sums in other orders)


def phase_train(card) -> None:
    """examples/model/torch_train_black_scholes.py on the card: TRAIN_STEPS
    Adam steps from init_params(0), the weights written to a temporary
    directory, the wall time (to a synchronise); gated: the last loss below
    the first / 10, every weight finite and in the shapes load_weights()
    reads, examples/model/weights.npz untouched; then TRAIN_CHECK_STEPS
    steps on the card and on the CPU, the loss after them within
    TRAIN_RTOL."""
    import contextlib
    import io
    import tempfile

    mod = example_module("model/torch_train_black_scholes")
    weights = os.path.join(ROOT, "examples", "model", "weights.npz")
    before = os.path.exists(weights) and os.stat(weights).st_mtime_ns
    printed = io.StringIO()
    with tempfile.TemporaryDirectory() as d, contextlib.redirect_stdout(printed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model, losses = mod.train(TRAIN_STEPS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        lines = printed.getvalue().splitlines()
        mod.save_weights(model, os.path.join(d, "w.npz"))
        saved = dict(np.load(os.path.join(d, "w.npz")))
        card_check = mod.train(TRAIN_CHECK_STEPS)[1][-1]
        cpu_check = mod.train(TRAIN_CHECK_STEPS, device="cpu")[1][-1]
    shapes = {k: list(v.shape) for k, v in saved.items()}
    finite = all(np.isfinite(v).all() for v in saved.values())
    after = os.path.exists(weights) and os.stat(weights).st_mtime_ns
    emit({"phase": "train", "card": card, "steps": TRAIN_STEPS, "seconds": wall, "first_loss": float(losses[0]),
          "final_loss": float(losses[-1]), "weights_shapes": shapes, "weights_finite": finite,
          "printed": lines, f"card_loss_after_{TRAIN_CHECK_STEPS}": float(card_check),
          f"cpu_loss_after_{TRAIN_CHECK_STEPS}": float(cpu_check), "weights_npz_untouched": before == after})
    want = {"w1": [2, 64], "b1": [64], "w2": [64, 64], "b2": [64], "w3": [64, 1], "b3": [1]}
    if not (losses[-1] < losses[0] / 10 and finite and shapes == want and before == after
            and abs(card_check - cpu_check) <= TRAIN_RTOL * abs(cpu_check)):
        raise AssertionError(f"train: losses {losses[0]} -> {losses[-1]}, finite {finite}, shapes {shapes}, "
                             f"weights.npz untouched {before == after}, after {TRAIN_CHECK_STEPS} steps card "
                             f"{card_check} against CPU {cpu_check}")


def plain_step(kernels, f, dev, cols, mult, z, alpha):
    """prover_step's result from the plain twins on the card, one device."""
    t = f.u32_to_tensor(cols, dev)
    evals = kernels.circle_lde_plain(kernels.circle_ifft_plain(t), 1)
    log = evals.shape[1].bit_length() - 1
    desc = kernels.TreeDesc(kernels.tree_layers(log, dev), {log: evals})
    kernels.merkle_tree_plain(desc)
    claimed = kernels.logup_sum_plain(t[:MESH_REL_COLS], f.u32_to_tensor(mult, dev), z, alpha)
    return f.tensor_to_u32(evals), f.tensor_to_u32(desc.layers[0][0]), f.tensor_to_u32(claimed)


def phase_mesh_step(S, kernels, f, dev, card) -> dict:
    """prover_step at both shapes over virtual meshes of the card (1, 2 and
    4 shards, 2 x 2 ('rows', 'cols')): the launches of each first call
    (counters set to 0 just before it) gated to the plan
    (sharding.step_launches: K1 a column shard, K2 a row shard and the
    top, logup_sum a row shard, nothing else); evals, root and claimed
    equal to the one-shard result and the twins' (the CPU's at the
    reference's shape, the twins on the card at full width); the
    reshard's bytes beside (n - 1)/n of the tree's; host seconds of 3
    more calls.  Returns the launches of the full-width 4-shard call (the
    kernels line's run for logup_sum)."""
    t_phase = time.perf_counter()
    main = None
    for name, (n_cols, log) in MESH_STEP_SHAPES.items():
        cols, mult, z, alpha = step_inputs(n_cols, log)
        if name == "reference":
            want = S.prover_step(S.make_chip_mesh(1, devices=["cpu"]), cols, mult, z, alpha, n_rel_cols=MESH_REL_COLS)
        else:
            want = plain_step(kernels, f, dev, cols, mult, z, alpha)
        one = None
        for kind in MESH_KINDS:
            mesh = mesh_of(S, kind, [dev] * 4)
            stats = {}
            kernels.reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = S.prover_step(mesh, cols, mult, z, alpha, n_rel_cols=MESH_REL_COLS, stats=stats)
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
            launches = kernels.counts()
            first = {k: v for k, v in launches.items() if v}
            launches["fri_channel_steps_in_root_passes"] = kernels.CHANNEL.hosted
            by_shard = {str(k): dict(v) for k, v in kernels.SHARD_LAUNCHES.items()}
            plan = S.step_launches(mesh, n_cols, log, 1)
            if name == "full_width" and kind == "4":
                main = dict(launches)
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                S.prover_step(mesh, cols, mult, z, alpha, n_rel_cols=MESH_REL_COLS)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            one = got if one is None else one
            equal = all(np.array_equal(g, w) and np.array_equal(g, o) for g, w, o in zip(got, want, one))
            n = mesh.size
            emit({"phase": "mesh_step", "shape": name, "columns": n_cols, "rows": 1 << log, "mesh": mesh.shape,
                  "virtual": mesh.virtual, "card": card, "first_seconds": first_s, "seconds": times,
                  "seconds_median": statistics.median(times),
                  "launches": first,
                  "launches_planned": plan, "launches_by_shard": by_shard, "reshard_bytes": stats["moved_bytes"],
                  "block_exchange_bytes": stats["tree_bytes"] * (n - 1) // n, "tree_bytes": stats["tree_bytes"],
                  "equal_one_shard_and_twins": equal})
            if first != plan or not equal:
                raise AssertionError(f"prover_step {name} over {mesh}: launches {launches} (planned {plan}), "
                                     f"results equal: {equal}")
            if stats["moved_bytes"] * n != stats["tree_bytes"] * (n - 1):
                raise AssertionError(f"prover_step {name} over {mesh}: the reshard moved {stats['moved_bytes']} bytes")
    emit({"phase": "mesh_steps", "seconds": time.perf_counter() - t_phase})
    return main


def phase_mesh_prove(T, S, kernels, serde, tape, card, tag, pie, settings, proof, devices=None) -> dict:
    """The path's card PIE proved under prove_mesh over 2 and 4 shards (of
    the card, or of `devices`): the first prove with every launch counter
    set to 0 just before it and every plain twin refused, the same bytes
    as the path's one-device proof, native/ accepting them; 3 timed proves
    beside 3 one-device proves; the bytes of one prove gathered onto the
    lead (gated at or below sharding.expected_gathered_bytes, the formula
    of the module's docstring), moved between shards and scattered from
    the lead, K1-K7 and K9 launches per shard, peak device memory (on
    distinct cards, each card's).  Every row shard must launch K1-K6, K5
    and K6 exactly once (every block of the shard in one launch), and
    every one but the first K5's carry pass exactly once (every component's
    block in one launch), the first none.  In the host's records of one
    more prove (profiled, every twin refused): one cumsum (the carries)
    and one carry copy a shard after the first.  Returns {shards:
    launches}."""
    from luminair_tpu_torch.air.layout import AirLayout

    t_phase = time.perf_counter()
    one_bytes = serde.proof_to_flat_bytes(proof)
    virtual = devices is None
    out = {}
    for n in MESH_PROVE_SHARDS:
        devs = [torch.device("cuda", torch.cuda.current_device())] * n if virtual else devices[:n]
        if len(devs) < n:
            continue
        mesh = S.make_chip_mesh(n, devices=devs)
        one_s = []
        for _ in range(3):
            t0 = time.perf_counter()
            T.prove(pie, settings)
            torch.cuda.synchronize()
            one_s.append(time.perf_counter() - t0)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_counts()
        S.reset_bytes()
        for d in set(devs):
            torch.cuda.reset_peak_memory_stats(d)
        with twins_refused(kernels, tape), S.prove_mesh(mesh):
            t0 = time.perf_counter()
            got = T.prove(pie, settings)
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
        launches = kernels.counts()
        launches["fri_channel_steps_in_root_passes"] = kernels.CHANNEL.hosted
        by_shard = {str(k): {name: v.get(name, 0) for name in MESH_PROVE_KERNELS}
                    for k, v in kernels.SHARD_LAUNCHES.items()}
        moved = dict(S.BYTES)
        peak = torch.cuda.max_memory_allocated()
        peaks = {str(d): torch.cuda.max_memory_allocated(d) for d in sorted(set(devs), key=str)}
        lay = AirLayout(got.claim, settings)
        formula = S.expected_gathered_bytes(n, [lay.pp_logs(), lay.main_logs, lay.inter_logs,
                                                [lay.composition_log] * 4], got.config.log_blowup, got.config.fri)
        pb = serde.proof_to_flat_bytes(got)
        if pb != one_bytes:
            raise AssertionError(f"{tag}: the proof over {mesh} differs from the one-device proof")
        verify_s = native_verify(serde, pb, settings, f"{tag} over {n} shards")
        times = []
        with S.prove_mesh(mesh):
            for _ in range(3):
                t0 = time.perf_counter()
                T.prove(pie, settings)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
        with twins_refused(kernels, tape), S.prove_mesh(mesh):
            ops = Profiled(lambda: T.prove(pie, settings), record_shapes=True).ops
        cumsums = sum(1 for op in ops if op[0] == "aten::cumsum")
        carries = [op[1][0] for op in ops if carry_copy(op)]
        emit({"phase": "mesh_prove", "path": tag, "card": card, "shards": n, "virtual": mesh.virtual,
              "devices": [str(d) for d in devs], "first_prove_seconds": first_s, "prove_seconds": times,
              "prove_seconds_median": statistics.median(times), "one_device_seconds": one_s,
              "one_device_median": statistics.median(one_s), "gathered_bytes": moved["gathered"],
              "gathered_bytes_formula": formula,
              **({"parent_gathered_bytes": PARENT_PINN_GATHERED_4} if tag.startswith("pinn") and n == 4 else {}),
              "moved_bytes": moved["moved"], "scattered_bytes": moved["scattered"],
              "launches": {k: v for k, v in launches.items() if v},
              "launches_by_shard": by_shard, "peak_device_bytes": peak, "peak_device_bytes_by_card": peaks,
              "proof_bytes_equal_one_device": True,
              "twins_called": 0, "native_verify": "accepted", "native_verify_seconds": verify_s,
              "cumsums": cumsums, "carry_copies": len(carries), "carry_copy_shapes": carries})
        if cumsums != 1 or len(carries) != n - 1:
            raise AssertionError(f"{tag} over {n} shards: {cumsums} cumsums (1 planned) and {len(carries)} carry "
                                 f"copies (one a shard after the first) in the host's records of a prove")
        short = [r for r in range(n) if not all(by_shard.get(str(r), {}).get(k) for k in MESH_ROW_KERNELS)
                 or by_shard.get(str(r), {}).get("add_carry", 0) != int(r > 0)
                 or any(by_shard.get(str(r), {}).get(k) != 1 for k in ("air_witness", "air_domain"))]
        if short or not any(by_shard.get(str(r), {}).get("oods_eval") for r in range(n)):
            raise AssertionError(f"{tag} over {n} shards: shards {short} launched not every one of K1-K6 (K5 and K6 "
                                 "once each, the carry pass once on each but the first, none on the first), or none "
                                 f"K7: {by_shard}")
        if moved["gathered"] > formula:
            raise AssertionError(f"{tag} over {n} shards: {moved['gathered']} bytes gathered onto the lead, the "
                                 f"formula {formula}")
        out[n] = launches
    emit({"phase": "mesh_proves", "path": tag, "virtual": virtual, "seconds": time.perf_counter() - t_phase})
    return out


def carry_copy(op) -> bool:
    """A host record of aten::to (recorded with its shapes) that moves a
    (C, 4) int32 tensor to a device without waiting: a shard's C carries
    (sharding.air_witness_many).  On one card it returns the tensor
    itself, but the host still records the call."""
    name, shapes, dtypes, scalars = op
    return (name == "aten::to" and bool(shapes) and len(shapes[0]) == 2 and shapes[0][1] == 4 and dtypes[:1] == ["int"]
            and True in scalars)


def phase_mesh_kernels(T, S, kernels, tape, f, dev, card, tag, pie, settings) -> tuple:
    """K3-K6 in their row-shard modes at the path's shapes, against their
    twins: the card PIE proved under prove_mesh over MESH_KERNEL_SHARDS
    shards of the card at each of MESH_KERNEL_BLOWUPS, every call of the
    modes' wrappers kept (recording; the counters set to 0 just before the
    prove and its launches by shard read just after), then each kept call
    through its kernel and through its twin on the same inputs -- K5 on a
    row block (the twin with the same carry argument), the carry pass, K6
    on a row block with its row offset and halo, K4's plan of a row shard,
    K3 on a block assembled in nested mirror order -- bit for bit.  Fails
    if a word differs, a shard did not launch K3-K6 (and each but the first
    the carry pass exactly once, the first none), or a mode never ran: K6
    with a halo at each stride, a K4 plan of a shard r > 0, a carry pass.
    Then the largest carry pass and K6 call with a halo timed.  Returns ({kernel: max_abs_err}, the
    kernels line's add_carry row)."""
    t_phase = time.perf_counter()
    twins = {k: v for k, v in path_twins(kernels, tape, f).items() if k in MESH_KERNEL_TWINS}
    mesh = S.make_chip_mesh(MESH_KERNEL_SHARDS, devices=[dev] * MESH_KERNEL_SHARDS)
    errs, row, halo_ms = {}, None, {}
    for blowup in MESH_KERNEL_BLOWUPS:
        kept, calls = {}, {}
        cfg = T.PcsConfig(fri=T.FriConfig(log_blowup_factor=blowup))
        kernels.reset_counts()
        with recording(kernels, twins, kept, calls), S.prove_mesh(mesh):
            T.prove(pie, settings, cfg)
        torch.cuda.synchronize()
        by_shard = {str(k): dict(v) for k, v in kernels.SHARD_LAUNCHES.items()}
        by_kernel = replay(kernels, twins, kept, calls)
        calls6 = [a for key, a in kept.items() if key[0] == "air_domain_many"]
        domains = [b for a in calls6 for b in a["blocks"] if b.terms[0].halo is not None]
        modes = {
            "air_domain with a halo": sum(1 for b in domains if b.stride == 1 << blowup),
            "deep_quotient_many of a shard r > 0": sum(1 for key, a in kept.items()
                                                       if key[0] == "deep_quotient_many" and a["plan"].shard[0] > 0),
            "add_carry": calls.get("add_carry", 0),
        }
        short = [r for r in range(mesh.size) if not all(by_shard.get(str(r), {}).get(k) for k in (
            "fri_layer", "deep_quotient", "air_witness", "air_domain"))
            or by_shard.get(str(r), {}).get("add_carry", 0) != int(r > 0)
            or any(by_shard.get(str(r), {}).get(k) != 1 for k in ("air_witness", "air_domain"))]
        checked = {k: by_kernel[twins[k][0]] for k in MESH_KERNEL_TWINS}
        emit({"phase": "mesh_kernels", "path": tag, "card": card, "shards": mesh.size, "log_blowup": blowup,
              "launches_by_shard": by_shard, "calls": calls, "modes": modes,
              "checked": {k: {"calls_kept": len(r["shapes"]), "max_abs_err": r["max_abs_err"]}
                          for k, r in checked.items()}})
        for name, r in checked.items():
            errs[twins[name][0]] = max(errs.get(twins[name][0], 0), r["max_abs_err"])
        bad = [k for k, r in checked.items() if r["max_abs_err"] != 0 or not r["shapes"]]
        if bad or short or not all(modes.values()):
            raise AssertionError(f"{tag} over {mesh.size} shards at log blowup {blowup}: kernels that disagree with "
                                 f"their twins or never ran {bad}, shards that missed a launch {short}, modes {modes}")
        if blowup == MESH_KERNEL_BLOWUPS[0]:
            a = max((a for key, a in kept.items() if key[0] == "add_carry"),
                    key=lambda a: sum(b.numel() for b in a["rows"]))
            rows, carry = cloned(a["rows"]), a["carry"]
            row = dict(shape=f"the carry pass of a row shard: {len(rows)} blocks (K5's last entries), "
                             f"{sum(b.numel() for b in rows)} words, the largest (4, {max(b.shape[1] for b in rows)})",
                       err=errs["add_carry"], ms=time_ms(lambda: kernels.add_carry(rows, carry)),
                       plain_ms=time_ms(lambda: kernels.add_carry_plain(rows, carry)), bound=bound(*add_carry_work(a)))
        a = max(calls6, key=lambda a: sum(b.rows for b in a["blocks"]))
        ew = a["ew"]
        halo_ms[f"a shard's launch: {describe(a['blocks'])}"] = (
            time_ms(lambda: kernels.air_domain_many(a["blocks"], ew)), bound(*domain_work(a))[0])
        b = max((b for b in domains if any(t.tp.name == "mul" for t in b.terms)), key=lambda b: b.rows)
        blk = kernels.DomainBlock([t for t in b.terms if t.tp.name == "mul"], b.log_trace, b.stride, b.row0,
                                  b.log_domain)
        halo_ms[f"stride {blk.stride}, block {blk.rows} rows of mul alone"] = (
            time_ms(lambda: kernels.air_domain_many([blk], ew)), bound(*domain_work({"blocks": [blk]}))[0])
        del kept, domains, a, b, blk, calls6
        torch.cuda.empty_cache()
    emit({"phase": "kernel_time", "kernel": "add_carry", "shape": row["shape"], "ms": row["ms"],
          "plain_ms": row["plain_ms"], "bound_ms": row["bound"][0], "bound_by": row["bound"][1]})
    for shape, (ms, b) in halo_ms.items():
        emit({"phase": "kernel_time_extra", "kernel": "air_domain", "shape": f"a row block with its halo, {shape}",
              "ms": ms, "bound_ms": b})
    emit({"phase": "mesh_kernels_done", "path": tag, "seconds": time.perf_counter() - t_phase})
    return errs, row


def phase_mesh_devices(T, S, kernels, serde, tape, card, tag, pie, settings, proof) -> None:
    """The two proves over distinct cards where the machine has two or more;
    else one line saying that no run had them."""
    cards = torch.cuda.device_count()
    if cards < 2:
        emit({"phase": "mesh_devices", "path": tag, "cards": cards, "ran": False})
        return
    phase_mesh_prove(T, S, kernels, serde, tape, card, tag, pie, settings, proof,
                     devices=[torch.device("cuda", i) for i in range(cards)])


def phase_dryrun(card) -> None:
    from luminair_tpu_torch import graft_entry

    r = graft_entry.dryrun_multichip(4)
    emit({"phase": "dryrun_multichip", "card": card, "printed": r["printed"], "virtual": r["virtual"],
          "devices": r["devices"], "forward_rel_err": r["forward_rel_err"], "meshes": r["meshes"],
          "seconds": r["seconds"]})


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from luminair_tpu_torch import fields as f
    from luminair_tpu_torch import circle, kernels, serde, tracing
    from luminair_tpu_torch import prelude as T
    from luminair_tpu_torch.air import tape
    from luminair_tpu_torch.models import black_scholes as BS
    from luminair_tpu_torch.parallel import sharding as S

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = phase_card()
    phase_build(kernels)
    field_rate(dev)
    bench_tag, pinn_tag = f"bench_n{N_MAIN}", f"pinn_b{PINN_BATCH}"
    hs_tag = pinn_tag + "_hs"
    paths = {
        bench_tag: (lambda: bench_graph(T, N_MAIN), None),
        pinn_tag: (lambda: pinn_graph(T, BS), lambda out: {"model_max_abs_err": float(np.max(np.abs(
            np.asarray(out.data()).reshape(-1) - BS.reference_forward(*pinn_inputs(BS)).reshape(-1))))}),
    }
    b2_tag, debug_tag = pinn_tag + "_b2", "debug_" + pinn_tag
    # The bench graph has no reduction and no LUT: no T3, no T4.  The check
    # (air_check) is on no prove path.
    expect = {
        bench_tag: [k.name for k in kernels.KERNELS
                    if k.name not in ("trace_reduce", "lut_boundary", "air_check", "logup_sum", "add_carry")],
        pinn_tag: [k.name for k in kernels.KERNELS if k.name not in ("air_check", "logup_sum", "add_carry")],
    }
    # A prove from a PIE: K1-K10, no trace kernel.  logup_sum is prover_step's (phase mesh_step),
    # add_carry a mesh prove's (phase mesh_prove).
    expect[hs_tag] = expect[b2_tag] = [k.name for k in kernels.KERNELS if k.name not in (
        "trace_segment", "trace_reduce", "lut_boundary", "air_check", "logup_sum", "add_carry")]
    # K3: the largest input's circle fold and one launch a committed FRI
    # layer (7 layers at N=256, 9 at the PINN).
    k3_limit = {bench_tag: 8, pinn_tag: 10, hs_tag: 10}
    # The run whose launch counts the kernels line gives: the PINN's prove,
    # the check's on the PINN's card PIE.
    main_path = {"air_check": debug_tag, "logup_sum": "mesh_step", "add_carry": f"mesh_{pinn_tag}_{MESH_KERNEL_SHARDS}"}
    pinn_host = host_trace(paths[pinn_tag][0])
    emit({"phase": "pinn_host_trace", "batch": PINN_BATCH, "trace_cells": trace_cells(pinn_host[0]),
          "settings_host_seconds": pinn_host[2], "trace_host_seconds": pinn_host[3]})
    pinn_logs = {k: t.log_size for k, t in pinn_host[0].trace_tables.items() if t.n_rows}
    rows = phase_kernels(kernels, circle, f, dev, pinn_logs)
    rows["logup_sum"] = phase_logup_kernel(kernels, f, dev)
    phase_logup_plan(S, kernels, f, dev, card, rows["logup_sum"])

    launches, path_errs = {}, {}
    # The kernel checks' buffers (2^27-word LDEs) stay out of the first
    # path's peak.
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for tag, (build, check) in paths.items():
        host = pinn_host if tag == pinn_tag else host_trace(build)
        launches[tag], pie, settings, proof = phase_path(T, kernels, serde, tracing, f, card, tag, build, host,
                                                         expect[tag], k3_limit[tag], check)
        peak = torch.cuda.max_memory_allocated()
        path_errs["verify_" + tag] = phase_verify(T, kernels, serde, tracing, tape, f, card, tag, pie, settings, proof)
        for n, c in phase_mesh_prove(T, S, kernels, serde, tape, card, tag, pie, settings, proof).items():
            launches[f"mesh_{tag}_{n}"] = c
        if tag == pinn_tag:
            path_errs["mesh_kernels"], rows["add_carry"] = phase_mesh_kernels(T, S, kernels, tape, f, dev, card, tag,
                                                                            pie, settings)
        phase_mesh_devices(T, S, kernels, serde, tape, card, tag, pie, settings, proof)
        del proof

        def settings_trace_prove():
            cx, _ = build()
            s = T.gen_circuit_settings(cx)
            T.prove(T.gen_trace(cx, s), s)

        path_errs[tag], kept = phase_path_kernels(T, kernels, tape, f, tag, settings_trace_prove, expect[tag])
        if tag == pinn_tag:
            rows.update(trace_kernel_rows(kernels, kept))
            pow_call_extra(kernels, kept)
        ch = channel_steps(kernels, kept)
        del kept
        torch.cuda.empty_cache()
        channel_per_prove(tag, ch, phase_profile(tag, "prove", lambda: T.prove(pie, settings)))
        cx, _ = build()
        phase_profile(tag, "settings", lambda: T.gen_circuit_settings(cx))
        phase_profile(tag, "trace", lambda: T.gen_trace(cx, settings))
        if tag == pinn_tag:
            # The same PIE and settings (the trace does not depend on the
            # PCS profile) at the 80-bit profile.
            torch.cuda.reset_peak_memory_stats()
            launches[hs_tag], path_errs[hs_tag], kept, proof = phase_high_security(
                T, kernels, serde, tracing, tape, f, card, hs_tag, pie, settings, host, expect[hs_tag],
                k3_limit[hs_tag])
            # The profile, with the last FRI layer where prove() clamps it
            # for the smallest committed column.
            profile = T.PcsConfig.high_security()
            profile.fri.log_last_layer_degree_bound = proof.config.fri.log_last_layer_degree_bound
            path_errs["verify_" + hs_tag] = phase_verify(T, kernels, serde, tracing, tape, f, card, hs_tag, pie,
                                                         settings, proof, T.PcsConfig.high_security(), profile, 80,
                                                         shared_from=pinn_tag)
            del proof
            ch = channel_steps(kernels, kept)
            rows.update(transcript_kernel_rows(kernels, kept, ch))
            del kept
            torch.cuda.empty_cache()
            channel_per_prove(hs_tag, ch, phase_profile(hs_tag, "prove",
                                                        lambda: T.prove(pie, settings, T.PcsConfig.high_security())))
            launches[b2_tag] = phase_pinn_blowup(T, kernels, serde, card, b2_tag, pie, settings, host, expect[b2_tag],
                                                 peak)
            launches[debug_tag], path_errs[debug_tag] = phase_debug_pinn(T, kernels, tape, f, card, tag, pie,
                                                                         settings)
        del host, pie, settings, cx
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    path_errs["op_graphs"], (pie, settings, proof), graphs = phase_op_graphs(T, kernels, serde, tape, f, card)
    path_errs["verify_all_ops"] = phase_verify(T, kernels, serde, tracing, tape, f, card, "all_ops", pie, settings,
                                               proof)
    del pie, settings, proof
    phase_op_graph_blowups(T, serde, card, graphs)
    path_errs["debug_op_graphs"] = phase_debug_graphs(T, kernels, tape, f, card, graphs, pinn_logs)
    del graphs
    phase_examples(kernels, card)
    phase_parity(T, serde)
    launches["mesh_step"] = phase_mesh_step(S, kernels, f, dev, card)
    phase_dryrun(card)
    phase_train(card)

    launches.update({"verify_" + tag: c for tag, c in VERIFY_LAUNCHES.items()})
    line = []
    for k in kernels.KERNELS:
        r = rows[k.name]
        line.append({
            "name": k.name, "route": "cuda", "source": f"luminair_tpu_torch/csrc/{k.source}",
            "replaces": k.replaces, "launches": launches[main_path.get(k.name, pinn_tag)][k.name],
            "launches_by_path": {p: c[k.name] for p, c in launches.items()},
            **({"steps_in_root_passes_by_path": {p: c["fri_channel_steps_in_root_passes"] for p, c in launches.items()}}
               if k is kernels.CHANNEL else {}),
            "max_abs_err": max([r["err"]] + [e.get(k.name, 0) for e in path_errs.values()]),
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
            "bound_by": r["bound"][1], "library_ms": r.get("library"),
        })
    emit({"kernels": line})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
