"""DeFi risk assessment with ZK proofs on the PyTorch/CUDA port
(luminair_tpu_torch): VaR, CVaR and max loss over sorted loss scenarios,
with less_than masks, sum_reduce and recip, proved and verified (the
port's verifier and native/).

    python3 examples/torch_risk_assessment.py          # on the CUDA device
    python3 examples/torch_risk_assessment.py --cpu    # on the CPU

The scenario set and the tolerances are the reference's
(examples/risk-assessment/src/main.rs:47-100).
"""

import math
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from luminair_tpu_torch import native
from luminair_tpu_torch.prelude import Graph, gen_circuit_settings, gen_trace, prove, verify

# 44 market scenarios: positive = loss %, negative = profit %, sorted
# worst -> best before entering the circuit.
SCENARIO_LOSSES = sorted(
    [
        48.0, 42.5, 39.8, 35.2, 31.7, 28.4, 26.9, 24.3, 22.8, 21.5,
        19.7, 18.2, 17.6, 16.1, 15.4, 14.8, 13.9, 13.2, 12.7, 11.8,
        11.1, 10.4, 9.8, 9.1, 8.6, 7.9, 7.2, 6.8, 6.1, 5.4,
        4.9, 4.2, 3.8, 3.1, 2.6, 1.9, 1.2, 0.8, 0.2, -0.5,
        -1.2, -2.4, -3.8, -5.1,
    ],
    reverse=True,
)
CONFIDENCE = 0.95


def main(device=None) -> dict:
    """Runs the example on `device` (the CUDA device when None; raises
    without one) and returns what it printed (`printed`, one string a
    line), VaR, CVaR and max loss, the proof, the settings and the seconds
    of the prove and of each verify."""
    printed = []

    def say(line: str) -> None:
        print(line, flush=True)
        printed.append(line)

    losses_list = SCENARIO_LOSSES
    n = len(losses_list)
    tail = max(1, min(n, math.ceil((1.0 - CONFIDENCE) * n)))
    var_index = tail - 1

    cx = Graph()
    losses = cx.tensor((n,)).set(losses_list)
    idx = cx.tensor((n,)).set(list(range(n)))
    tail_t = cx.tensor((n,)).set([float(tail)] * n)
    var_t = cx.tensor((n,)).set([float(var_index)] * n)
    zero_t = cx.tensor((n,)).set([0.0] * n)
    one_t = cx.tensor((n,)).set([1.0] * n)

    # CVaR: expected loss in the tail.
    tail_mask = idx < tail_t
    tail_losses_sum = (losses * tail_mask).sum_reduce(0)
    tail_count = tail_mask.sum_reduce(0)
    cvar = (tail_losses_sum * tail_count.recip()).retrieve()

    # VaR: the loss at the tail boundary (one-hot by two comparisons).
    var_onehot = (idx < tail_t) - (idx < var_t)
    var_value = (losses * var_onehot).sum_reduce(0).retrieve()

    # Max loss: one-hot at index 0.
    max_onehot = (idx < one_t) - (idx < zero_t)
    max_loss = (losses * max_onehot).sum_reduce(0).retrieve()

    cx.compile()
    settings = gen_circuit_settings(cx, device=device)
    pie = gen_trace(cx, settings, device=device)

    t0 = time.perf_counter()
    proof = prove(pie, settings, device=device)
    prove_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    assert verify(proof, settings, device=device)
    verify_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    assert native.verify(proof, settings)
    native_s = time.perf_counter() - t0

    arr = np.array(losses_list)
    expect_cvar = arr[:tail].mean()
    got = {"var": var_value.data()[0], "cvar": cvar.data()[0], "max_loss": max_loss.data()[0]}
    say(f"VaR_{CONFIDENCE}:  {got['var']:.2f}%  (expected {arr[var_index]:.2f})")
    say(f"CVaR:      {got['cvar']:.2f}%  (expected {expect_cvar:.2f})")
    say(f"Max loss:  {got['max_loss']:.2f}%  (expected {arr[0]:.2f})")
    say(f"prove {prove_s:.2f}s  verify {verify_s:.2f}s  native/ {native_s:.2f}s")
    assert abs(got["var"] - arr[var_index]) < 0.05
    assert abs(got["cvar"] - expect_cvar) < 0.1
    assert abs(got["max_loss"] - arr[0]) < 0.05
    return {"printed": printed, **got, "proof": proof, "settings": settings, "prove_seconds": prove_s,
            "verify_seconds": verify_s, "native_verify_seconds": native_s}


if __name__ == "__main__":
    main(device="cpu" if "--cpu" in sys.argv[1:] else None)
