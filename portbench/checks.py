"""What decides `correct`: the requests the window finished, judged by the
plain reference once the window has closed and the program's state is
freed.

Numbers compared, each with its limit (all exact, limit 0):

- requests_failed: requests that raised instead of returning a proof.
- outputs_off: retrieved output values that differ from the reference's
  fixed-point forward pass on the same inputs and weights (every request
  whose outputs the harness kept: all where they are small, else the
  checked ones).
- settings_off: bytes by which the program's circuit settings (the LUT
  ranges and output tables of these inputs) differ from the ones the
  reference works out, over the checked requests.
- header_off: fields of a proof's head that differ from what the
  statement fixes: the mix's PCS profile on every request; the claim's
  log sizes and the clamped last-layer bound on the checked ones.
- proofs_rejected: checked proofs that the frozen standalone verifier
  rejects against the reference's settings at the mix's security bits.

The checked requests are drawn from the seed (reservoir sampling over the
window) and always hold the slowest.
"""

from __future__ import annotations

import sys
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from .reference import fixed as fx
from .reference import proof as proof_head
from .reference import settings as ref_settings
from .statement import INDEX, Pcs, Statement

LIMITS = {"requests_failed": 0, "outputs_off": 0, "settings_off": 0, "header_off": 0, "proofs_rejected": 0}
KEEP_OUTPUT_BYTES = 1 << 20  # outputs at most this large are kept for every request
FORWARD_THREADS = 4  # the reference's passes in threads (numpy releases the interpreter lock)


@dataclass(eq=False)
class Done:
    """A finished request, as the harness keeps it."""

    index: int
    seconds: float
    stages: Dict[str, float]
    proof: bytes
    outputs: Optional[np.ndarray] = None
    settings: object = None  # the program's settings, on checked requests (flat bytes once judged)
    inputs: Optional[dict] = None  # on checked requests

    def strip(self, keep_outputs: bool) -> None:
        """Drop what only a checked request needs."""
        self.settings = self.inputs = None
        if not keep_outputs:
            self.outputs = None


@dataclass
class Sample:
    """The checked requests: `k` - 1 drawn uniformly over the window by
    reservoir sampling from the seed, and the slowest."""

    rng: np.random.Generator
    k: int
    seen: int = 0
    drawn: List[Done] = field(default_factory=list)
    slowest: Optional[Done] = None

    def wants(self, seconds: float) -> bool:
        """Whether the next request (of `seconds`) is kept: decided before
        its settings and inputs are stored."""
        self.seen += 1
        self._slot = None
        if len(self.drawn) < self.k - 1:
            self._slot = len(self.drawn)
        else:
            j = int(self.rng.integers(self.seen))
            if j < self.k - 1:
                self._slot = j
        self._slow = self.slowest is None or seconds > self.slowest.seconds
        return self._slot is not None or self._slow

    def keep(self, done: Done) -> List[Done]:
        """Keep `done`; returns the requests no longer checked."""
        before = self.checked
        if self._slot is not None:
            if self._slot < len(self.drawn):
                self.drawn[self._slot] = done
            else:
                self.drawn.append(done)
        if self._slow:
            self.slowest = done
        now = {id(d) for d in self.checked}
        return [d for d in before if id(d) not in now]

    @property
    def checked(self) -> List[Done]:
        out = {d.index: d for d in self.drawn}
        if self.slowest is not None:
            out[self.slowest.index] = self.slowest
        return [out[i] for i in sorted(out)]


def bytes_off(a: bytes, b: bytes) -> int:
    n = min(len(a), len(b))
    x, y = np.frombuffer(a[:n], np.uint8), np.frombuffer(b[:n], np.uint8)
    return int(np.count_nonzero(x != y)) + abs(len(a) - len(b))


def outputs_off(program: np.ndarray, ref_raw: np.ndarray) -> int:
    program = np.asarray(program, dtype=np.float64).reshape(-1)
    ref = fx.to_float(ref_raw).reshape(-1)
    if program.shape != ref.shape:
        return max(program.size, ref.size)
    return int(np.count_nonzero(program != ref))


def statement_of(tape: fx.Tape) -> Statement:
    return Statement.of(tape, {k: lut.log_size for k, lut in ref_settings.luts(tape).items()})


def judge(cell, weights: dict, done: List[Done], checked: List[Done], failed: int, pcs: Pcs,
          inputs_of, verifier) -> tuple:
    """({number: value}, [Statement of each finished request], {checked
    request's index: (verifier's code, message)}).  `inputs_of(i)` gives
    request i's inputs again."""
    cfg, ref = cell.config, cell.reference
    numbers = dict.fromkeys(LIMITS, 0)
    numbers["requests_failed"] = failed
    checked = {d.index for d in checked}
    t0 = time.perf_counter()

    def forward(d: Done):
        """The reference's pass over one request; a statement with no
        lookup table is fixed by the shapes, so a request whose outputs
        were not kept and which is not checked reuses the first one."""
        if d.outputs is None and d.index not in checked and fixed_shapes:
            return None, fixed_shapes[0]
        inputs = d.inputs if d.inputs is not None else inputs_of(d.index)
        out, tape = ref.forward(cfg, weights, inputs)
        return out, tape

    fixed_shapes = []
    if done:
        out, tape = forward(done[0])
        if not tape.lut_sources and not tape.range_check:
            fixed_shapes.append(tape)
    with ThreadPoolExecutor(FORWARD_THREADS) as pool:
        passes = list(pool.map(forward, done))
    statements = []
    jobs = []
    for d, (out, tape) in zip(done, passes):
        st = statement_of(tape)
        statements.append(st)
        if d.outputs is not None:
            numbers["outputs_off"] += outputs_off(d.outputs, out)
        try:
            config, claim = proof_head.header(d.proof)
        except ValueError:
            numbers["header_off"] += 1
            continue
        for key in ("pow_bits", "log_blowup", "n_queries", "folds_per_layer"):
            numbers["header_off"] += config[key] != getattr(pcs, key)
        if d.index in checked:
            numbers["header_off"] += config["log_last_layer_degree_bound"] != st.last_layer_bound(pcs)
            want = {INDEX[n]: log for n, log in st.claim.items()}
            numbers["header_off"] += len(set(want.items()) ^ set(claim.items()))
            flat = ref_settings.flat_bytes(tape)
            numbers["settings_off"] += bytes_off(d.settings, flat)
            jobs.append((d.index, d.proof, flat))
    t = time.perf_counter()
    with ThreadPoolExecutor(max(1, len(jobs))) as pool:
        codes = list(pool.map(lambda j: verifier.verify(j[1], j[2], pcs.security_bits), jobs))
    numbers["proofs_rejected"] = sum(1 for code, _ in codes if code != 0) + len(checked) - len(jobs)
    print(f"portbench: the reference's passes {t - t0:.3f} s, the verifier {time.perf_counter() - t:.3f} s",
          file=sys.stderr)
    return numbers, statements, {j[0]: c for j, c in zip(jobs, codes)}


def verdict(numbers: Dict[str, int]) -> bool:
    return all(numbers[k] <= LIMITS[k] for k in LIMITS)
