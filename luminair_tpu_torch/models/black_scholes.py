"""The black-scholes PINN: a 2 -> 64 -> 64 -> 1 network (Linear + tanh)
that prices an option from (spot, volatility).  The repository's flagship
model.

Weights come from examples/model/weights.npz when that file exists;
otherwise from a deterministic normal initialisation (seed 1234, scale
1/sqrt(fan_in), zero biases).  The same numpy dict feeds any package that
builds the network, so two builds from it prove the same statement.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Tuple

import numpy as np

from ..graph.graph import Graph, GraphTensor
from ..nn import Linear

WEIGHTS_PATH = Path(__file__).resolve().parents[2] / "examples" / "model" / "weights.npz"
SIZES = ((2, 64), (64, 64), (64, 1))


def load_weights() -> Dict[str, np.ndarray]:
    if WEIGHTS_PATH.exists():
        z = np.load(WEIGHTS_PATH)
        return {k: z[k] for k in z.files}
    rng = np.random.default_rng(1234)
    w = {}
    for i, (fan_in, fan_out) in enumerate(SIZES, start=1):
        w[f"w{i}"] = rng.normal(scale=1.0 / np.sqrt(fan_in), size=(fan_in, fan_out))
        w[f"b{i}"] = np.zeros(fan_out)
    return w


def build(cx: Graph, w: Dict[str, np.ndarray], batch: int = 1) -> Tuple[GraphTensor, GraphTensor]:
    """Linear layers from `w` (w1, b1, w2, ...), tanh between them.
    Returns (input tensor of shape (batch, in), retrieved output)."""
    n_layers = len([k for k in w if k.startswith("w")])
    layers = []
    for i in range(1, n_layers + 1):
        fan_in, fan_out = w[f"w{i}"].shape
        layer = Linear(fan_in, fan_out, True, cx)
        layer.weight.set(w[f"w{i}"])
        layer.bias.set(w[f"b{i}"])
        layers.append(layer)
    x = cx.tensor((batch, layers[0].in_features))
    h = x
    for layer in layers[:-1]:
        h = layer(h).tanh()
    return x, layers[-1](h).retrieve()


def reference_forward(w: Dict[str, np.ndarray], x: np.ndarray) -> np.ndarray:
    """The float64 forward pass the fixed-point graph approximates."""
    n_layers = len([k for k in w if k.startswith("w")])
    h = np.asarray(x, dtype=np.float64)
    for i in range(1, n_layers):
        h = np.tanh(h @ w[f"w{i}"] + w[f"b{i}"])
    return h @ w[f"w{n_layers}"] + w[f"b{n_layers}"]
