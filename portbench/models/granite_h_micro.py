"""granite-4.0-h-micro's layers 10-19 on the program: one decode token
through the stage `models/granite_hybrid.py` builds, at
the configuration's share, the seeded weights set once."""

from __future__ import annotations


def build(cfg: dict, weights: dict):
    """(compiled graph, {input name: tensor}, retrieved output)."""
    from luminair_tpu_torch.graph.graph import Graph
    from luminair_tpu_torch.models import granite_hybrid

    cx = Graph()
    inputs, out = granite_hybrid.build(cx, cfg, weights)
    cx.compile()
    return cx, inputs, out
