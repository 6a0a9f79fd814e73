"""The N x N graph a * b + a on the program."""

from __future__ import annotations


def build(cfg: dict, weights: dict):
    """(compiled graph, {input name: tensor}, retrieved output)."""
    from luminair_tpu_torch.graph.graph import Graph

    n = cfg["n"]
    cx = Graph()
    a, b = cx.tensor((n, n)), cx.tensor((n, n))
    out = (a * b + a).retrieve()
    cx.compile()
    return cx, {"a": a, "b": b}, out
