"""Black-Scholes PINN inference with a ZK proof on the PyTorch/CUDA port
(luminair_tpu_torch): the 2 -> 64 -> 64 -> 1 network (Linear + tanh) of
luminair_tpu_torch/models/black_scholes.py prices one option, (spot 15.0,
volatility 0.5), proved and verified (the port's verifier and native/).

    python3 examples/torch_black_scholes_nn.py          # on the CUDA device
    python3 examples/torch_black_scholes_nn.py --cpu    # on the CPU (minutes)

The weights are `black_scholes.load_weights()`: examples/model/weights.npz
when it exists, else a seeded initialisation.  The input's exp2 lookup
table has 2^20 rows, so a run on the CPU takes minutes; `main` takes other
weights and inputs (a smaller network proves in seconds there).
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from luminair_tpu_torch import native
from luminair_tpu_torch.models import black_scholes as bs
from luminair_tpu_torch.prelude import Graph, gen_circuit_settings, gen_trace, prove, verify

INPUT = [[15.0, 0.5]]


def main(device=None, weights=None, x=None) -> dict:
    """Runs the example on `device` (the CUDA device when None; raises
    without one) with `weights` (default `load_weights()`) on the rows of
    `x` (default INPUT) and returns what it printed (`printed`, one string
    a line), the outputs and their float64 reference, the proof, the
    settings and the seconds of each stage."""
    printed = []

    def say(line: str) -> None:
        print(line, flush=True)
        printed.append(line)

    w = bs.load_weights() if weights is None else weights
    xs = np.asarray(INPUT if x is None else x, dtype=np.float64)
    cx = Graph()
    inp, out = bs.build(cx, w, batch=xs.shape[0])
    inp.set(xs)
    cx.compile()

    seconds = {}
    t0 = time.perf_counter()
    settings = gen_circuit_settings(cx, device=device)
    seconds["settings"] = time.perf_counter() - t0
    say(f"settings in {seconds['settings']:.2f}s")
    t0 = time.perf_counter()
    pie = gen_trace(cx, settings, device=device)
    seconds["trace"] = time.perf_counter() - t0
    say(f"trace in {seconds['trace']:.2f}s ({sum(t.n_rows for t in pie.trace_tables.values())} rows)")
    t0 = time.perf_counter()
    proof = prove(pie, settings, device=device)
    seconds["prove"] = time.perf_counter() - t0
    say(f"proof in {seconds['prove']:.2f}s")
    t0 = time.perf_counter()
    assert verify(proof, settings, device=device)
    seconds["verify"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    assert native.verify(proof, settings)
    seconds["native_verify"] = time.perf_counter() - t0
    say(f"verified in {seconds['verify']:.2f}s (native/ {seconds['native_verify']:.2f}s)")

    got = np.asarray(out.data(), dtype=np.float64).reshape(-1)
    expect = bs.reference_forward(w, xs).reshape(-1)
    say(f"Predicted option price: {got[0]:.6f} (float reference {expect[0]:.6f})")
    assert np.max(np.abs(got - expect)) < 0.05, "fixed-point drift too large"
    return {"printed": printed, "outputs": got, "reference": expect, "proof": proof, "settings": settings,
            "seconds": seconds}


if __name__ == "__main__":
    main(device="cpu" if "--cpu" in sys.argv[1:] else None)
