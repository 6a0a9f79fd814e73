"""The Black-Scholes PINN on the program: its own model builder
(`models/black_scholes.py`: Linear + tanh), the seeded weights set once,
the batch's input tensor `x`."""

from __future__ import annotations


def build(cfg: dict, weights: dict):
    """(compiled graph, {input name: tensor}, retrieved output)."""
    from luminair_tpu_torch.graph.graph import Graph
    from luminair_tpu_torch.models import black_scholes

    cx = Graph()
    x, out = black_scholes.build(cx, weights, batch=cfg["batch"])
    cx.compile()
    return cx, {"x": x}, out
