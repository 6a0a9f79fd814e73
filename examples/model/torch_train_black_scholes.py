"""Train the Black-Scholes PINN (2 -> 64 -> 64 -> 1, tanh) with PyTorch
and write its weights for the ZK inference examples.

The PyTorch counterpart of examples/model/train_black_scholes.py (JAX and
optax): the same 4096 (spot, time) points from default_rng(7), supervised
on the closed-form Black-Scholes call price, full-batch MSE, Adam at
1e-3 for 3000 steps, the loss printed every 500 steps.

    python3 examples/model/torch_train_black_scholes.py                 # on the CUDA device; writes nothing
    python3 examples/model/torch_train_black_scholes.py --out DIR/w.npz  # also writes the weights there
    python3 examples/model/torch_train_black_scholes.py --device cpu

Without --out the weights are not written.  luminair_tpu_torch's
models/black_scholes.py and examples/black_scholes_nn.py load
examples/model/weights.npz in place of their seeded weights when it
exists, so `--out examples/model/weights.npz` changes every PINN that is
proved afterwards and every figure recorded for one.
"""

import argparse
import os
import time

import numpy as np
import torch

K = 20.0  # strike
R = 0.05  # risk-free rate
SIGMA = 0.45  # volatility
T_MAX = 1.0
SIZES = ((2, 64), (64, 64), (64, 1))


def bs_call_price(S, t):
    """Closed-form Black-Scholes call price; t = time to expiry."""
    from scipy.stats import norm

    tau = np.maximum(t, 1e-6)
    d1 = (np.log(S / K) + (R + 0.5 * SIGMA**2) * tau) / (SIGMA * np.sqrt(tau))
    d2 = d1 - SIGMA * np.sqrt(tau)
    return S * norm.cdf(d1) - K * np.exp(-R * tau) * norm.cdf(d2)


def _norm_cdf(x):
    from math import erf, sqrt

    v = np.vectorize(lambda u: 0.5 * (1.0 + erf(u / sqrt(2.0))))
    return v(x)


def bs_call_price_noscipy(S, t):
    tau = np.maximum(t, 1e-6)
    d1 = (np.log(S / K) + (R + 0.5 * SIGMA**2) * tau) / (SIGMA * np.sqrt(tau))
    d2 = d1 - SIGMA * np.sqrt(tau)
    return S * _norm_cdf(d1) - K * np.exp(-R * tau) * _norm_cdf(d2)


def training_data(seed: int = 7, n: int = 4096):
    """(X (n, 2), Y (n, 1)) float32: spot and time drawn as the JAX
    script's main() draws them, and their call prices."""
    rng = np.random.default_rng(seed)
    S = rng.uniform(1.0, 40.0, size=n)
    t = rng.uniform(0.01, T_MAX, size=n)
    try:
        y = bs_call_price(S, t)
    except ImportError:
        y = bs_call_price_noscipy(S, t)
    return np.stack([S, t], axis=1).astype(np.float32), y.reshape(-1, 1).astype(np.float32)


class PINN(torch.nn.Module):
    """x @ w1 + b1, tanh, @ w2 + b2, tanh, @ w3 + b3; each weight (fan_in,
    fan_out), the layout of the saved weights."""

    def __init__(self, weights):
        super().__init__()
        for name, w in weights.items():
            self.register_parameter(name, torch.nn.Parameter(w))

    def forward(self, x):
        h = torch.tanh(x @ self.w1 + self.b1)
        h = torch.tanh(h @ self.w2 + self.b2)
        return h @ self.w3 + self.b3


def init_params(seed: int = 0) -> PINN:
    """The PINN on the CPU: each weight randn(fan_in, fan_out) /
    sqrt(fan_in), each bias zero, float32, drawn from a CPU
    torch.Generator seeded with `seed`.  The JAX script draws with
    jax.random, whose numbers no torch generator gives, so the two start
    from different weights."""
    gen = torch.Generator().manual_seed(seed)
    w = {}
    for i, (fan_in, fan_out) in enumerate(SIZES, start=1):
        w[f"w{i}"] = torch.randn(fan_in, fan_out, generator=gen) / float(np.sqrt(fan_in))
        w[f"b{i}"] = torch.zeros(fan_out)
    return PINN(w)


def _device(device) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to train on the CPU")
    return dev


def train(steps: int = 3000, lr: float = 1e-3, device=None, seed: int = 0):
    """Adam (optax's defaults: betas 0.9, 0.999, eps 1e-8) on the full-batch
    MSE of training_data(), from init_params(seed), on `device` (the CUDA
    device when None; raises without one), float32 products at full
    precision (no TF32; the setting is restored on return).  Prints the
    loss every 500 steps.  Returns (the PINN, the losses: before each step
    and after the last, steps + 1 float32 values)."""
    dev = _device(device)
    model = init_params(seed).to(dev)
    X, Y = (torch.from_numpy(a).to(dev) for a in training_data())
    opt = torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)
    precision = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    losses = []
    try:
        for i in range(steps + 1):
            loss = torch.mean((model(X) - Y) ** 2)
            losses.append(loss.detach())
            if i % 500 == 0:
                print(f"step {i}: loss {float(losses[-1]):.5f}", flush=True)
            if i == steps:
                break
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
    finally:
        torch.set_float32_matmul_precision(precision)
    return model, torch.stack(losses).cpu().numpy()


def weights_of(model: PINN) -> dict:
    """The PINN's weights as float64 numpy arrays, keys w1 b1 w2 b2 w3 b3."""
    return {k: v.detach().cpu().numpy().astype(np.float64) for k, v in model.named_parameters()}


def save_weights(params: PINN, path) -> None:
    """The weights as an .npz of float64 arrays w1 (2, 64), b1 (64,), w2
    (64, 64), b2 (64,), w3 (64, 1), b3 (1,): what
    luminair_tpu_torch.models.black_scholes.load_weights() reads."""
    np.savez(path, **weights_of(params))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="write the weights to this .npz (default: write nothing)")
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--device", default=None, help="default: the CUDA device")
    opts = ap.parse_args(argv)
    t0 = time.perf_counter()
    model, losses = train(opts.steps, device=opts.device)
    print(f"{opts.steps} steps in {time.perf_counter() - t0:.2f} s, final loss {losses[-1]:.5f}")
    if opts.out:
        save_weights(model, opts.out)
        print(f"saved {os.path.abspath(opts.out)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
