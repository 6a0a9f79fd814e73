"""Neural-net building blocks over the provable graph."""

from __future__ import annotations

import numpy as np

from ..graph.graph import Graph, GraphTensor


class Linear:
    """y = x @ W (+ b).  W: (in_features, out_features) -- transpose
    PyTorch-style (out, in) weights when loading."""

    def __init__(self, in_features: int, out_features: int, bias: bool, graph: Graph):
        self.in_features = in_features
        self.out_features = out_features
        self.weight = graph.tensor((in_features, out_features))
        self.bias = graph.tensor((out_features,)) if bias else None

    def set_torch_weights(self, w_out_in: np.ndarray, b: np.ndarray = None):
        """Load (out, in)-shaped weights (PyTorch nn.Linear layout)."""
        self.weight.set(np.asarray(w_out_in, dtype=np.float64).T.copy())
        if b is not None and self.bias is not None:
            self.bias.set(np.asarray(b, dtype=np.float64))
        return self

    def forward(self, x: GraphTensor) -> GraphTensor:
        out = x.matmul(self.weight)
        if self.bias is not None:
            out = out + self.bias.expand_to(out.shape)
        return out

    __call__ = forward


class ReLU:
    def __init__(self, *_):
        pass

    def forward(self, x):
        return x.relu()

    __call__ = forward


class Tanh:
    def forward(self, x):
        return x.tanh()

    __call__ = forward


class Sigmoid:
    def forward(self, x):
        return x.sigmoid()

    __call__ = forward
