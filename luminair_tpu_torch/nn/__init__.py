"""Neural-net building blocks over the provable graph."""

from __future__ import annotations

from typing import List

import numpy as np

from ..graph.graph import Graph, GraphTensor, concat


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


def _whole(t: GraphTensor) -> GraphTensor:
    """`t` as one node: a slice or a pad materialised once (a contiguous
    node), so that every op reading it shares that node."""
    return t if t.view.is_mult_uniform() else t.contiguous()


class RMSNorm:
    """x * rsqrt(mean(x^2) + eps) * w over the last dim of (1, dim) rows."""

    def __init__(self, dim: int, eps: float, graph: Graph):
        self.dim, self.eps = dim, eps
        self.weight = graph.tensor((dim,))

    def forward(self, x: GraphTensor) -> GraphTensor:
        mean = x.square().sum_reduce(1) * (1.0 / self.dim) + self.eps
        r = mean.sqrt().recip()
        return (x * r.insert_dim(1, self.dim)) * self.weight.reshape((1, self.dim))

    __call__ = forward


class GatedRMSNorm:
    """Mamba-2's gated norm, g = y * silu(z), g * rsqrt(mean(g^2) + eps) * w,
    over all `total` channels of which this module holds `dim`: the sum of
    the other holders' g^2 arrives as `ssq_rest` (shape (1,)), the value an
    all-reduce of the sums would deliver."""

    def __init__(self, dim: int, total: int, eps: float, graph: Graph):
        self.dim, self.total, self.eps = dim, total, eps
        self.weight = graph.tensor((dim,))

    def forward(self, y: GraphTensor, z: GraphTensor, ssq_rest: GraphTensor) -> GraphTensor:
        g = y * z.silu()
        mean = (g.square().sum_reduce(1) + ssq_rest) * (1.0 / self.total) + self.eps
        r = mean.sqrt().recip()
        return (g * r.insert_dim(1, self.dim)) * self.weight.reshape((1, self.dim))

    __call__ = forward


class SwiGLU:
    """The shared MLP, down(silu(x @ gate) * (x @ up)), over the `columns`
    of the intermediate width this module holds: its output is their part
    of the sum the down-projection makes."""

    def __init__(self, hidden: int, columns: int, graph: Graph):
        self.gate = Linear(hidden, columns, False, graph)
        self.up = Linear(hidden, columns, False, graph)
        self.down = Linear(columns, hidden, False, graph)

    def forward(self, x: GraphTensor) -> GraphTensor:
        return self.down(self.gate(x).silu() * self.up(x))

    __call__ = forward


class Mamba2Decode:
    """One token through Mamba-2's mixer, for the `heads` (of `head_dim`
    channels each) this module holds; B and C (`n_groups` = 1, `d_state`
    each) are computed whole by every holder.  The in-projection's columns
    are three weights, z, xBC (x of the held heads, B, C) and dt; the
    depthwise conv runs over the xBC channels' window of the `d_conv` - 1
    cached inputs and this one.  The step:

        xBC = silu(conv(window) + conv_bias); x, B, C = split(xBC)
        dt = softplus(dt + dt_bias); dA = exp(dt * -exp(A_log))
        state = state * dA + (x * dt) (outer) B
        y = state . C + x * D
        out = out_proj(gated_norm(y, z))

    Its output is the out-projection over the held channels: their part of
    the layer's sum."""

    def __init__(self, hidden: int, heads: int, head_dim: int, d_state: int, d_conv: int, total_channels: int,
                 eps: float, graph: Graph):
        self.heads, self.head_dim, self.d_state, self.d_conv = heads, head_dim, d_state, d_conv
        self.inner = heads * head_dim
        self.channels = self.inner + 2 * d_state
        self.in_z = Linear(hidden, self.inner, False, graph)
        self.in_xbc = Linear(hidden, self.channels, False, graph)
        self.in_dt = Linear(hidden, heads, False, graph)
        self.conv_weight = graph.tensor((self.channels, d_conv))
        self.conv_bias = graph.tensor((self.channels,))
        self.A_log = graph.tensor((heads,))
        self.dt_bias = graph.tensor((heads,))
        self.D = graph.tensor((heads,))
        self.norm = GatedRMSNorm(self.inner, total_channels, eps, graph)
        self.out_proj = Linear(self.inner, hidden, False, graph)

    def forward(self, h: GraphTensor, ssm_state: GraphTensor, conv_state: GraphTensor,
                ssq_rest: GraphTensor) -> GraphTensor:
        """h (1, hidden); ssm_state (heads, head_dim, d_state); conv_state
        (channels, d_conv - 1); ssq_rest (1,)."""
        nh, hd, ds, ch = self.heads, self.head_dim, self.d_state, self.channels
        new = self.in_xbc(h).permute((1, 0))  # (channels, 1)
        window = concat([conv_state, new], 1)  # (channels, d_conv)
        xbc = ((window * self.conv_weight).sum_reduce(1) + self.conv_bias).silu()
        x = _whole(xbc.slice_dim(0, 0, self.inner)).reshape((nh, hd))
        B = _whole(xbc.slice_dim(0, self.inner, self.inner + ds))
        C = _whole(xbc.slice_dim(0, self.inner + ds, ch))
        dt = (self.in_dt(h).reshape((nh,)) + self.dt_bias).softplus()
        dA = (dt * (self.A_log.exp() * -1.0)).exp()
        dBx = (x * dt.insert_dim(1, hd)).insert_dim(2, ds) * B.insert_dim(0, hd).insert_dim(0, nh)
        state = ssm_state * dA.insert_dim(1, hd).insert_dim(2, ds) + dBx
        y = (state * C.insert_dim(0, hd).insert_dim(0, nh)).sum_reduce(2) + x * self.D.insert_dim(1, hd)
        z = self.in_z(h)
        return self.out_proj(self.norm(y.reshape((1, self.inner)), z, ssq_rest))

    __call__ = forward


class GQADecode:
    """One token of grouped-query attention without position embedding
    (NoPE), for the query heads this module holds, each reading the KV head
    its group shares: scores = q . k * multiplier over the cached positions
    and this token's, a softmax, the values' weighted sum, and the
    out-projection of the held heads (their part of the layer's sum).  Each
    held query head has its own q and o weights, each KV head its k and v
    weights and cache (positions, head_dim)."""

    def __init__(self, hidden: int, kv_of_head: List[int], head_dim: int, positions: int, multiplier: float,
                 graph: Graph):
        self.kv_of_head, self.head_dim, self.positions, self.multiplier = kv_of_head, head_dim, positions, multiplier
        n_kv = max(kv_of_head) + 1
        self.q = [Linear(hidden, head_dim, False, graph) for _ in kv_of_head]
        self.o = [Linear(head_dim, hidden, False, graph) for _ in kv_of_head]
        self.k = [Linear(hidden, head_dim, False, graph) for _ in range(n_kv)]
        self.v = [Linear(hidden, head_dim, False, graph) for _ in range(n_kv)]
        # softmax(shift) keeps sum(exp) near one step of 2^shift (GraphTensor.softmax)
        self.shift = (positions + 1).bit_length() - 1

    def forward(self, h: GraphTensor, k_cache: List[GraphTensor], v_cache: List[GraphTensor]) -> GraphTensor:
        n, hd = self.positions, self.head_dim
        k_new = [k(h) for k in self.k]
        v_new = [v(h) for v in self.v]
        out = None
        for q_proj, o_proj, j in zip(self.q, self.o, self.kv_of_head):
            q = q_proj(h)  # (1, head_dim)
            s_cache = q.matmul(k_cache[j].permute((1, 0)))  # (1, positions)
            s_new = (q * k_new[j]).sum_reduce(1).reshape((1, 1))
            scores = concat([s_cache, s_new], 1) * self.multiplier
            p = scores.softmax(1, self.shift)  # 2^shift * softmax
            p_new = _whole(p.slice_dim(1, n, n + 1)).broadcast(1, hd)
            o = _whole(p.slice_dim(1, 0, n)).matmul(v_cache[j]) + p_new * v_new[j]
            part = o_proj(o.scale_pow2(self.shift))
            out = part if out is None else out + part
        return out

    __call__ = forward
