"""granite-4.0-h-micro's hybrid layers (HF `GraniteMoeHybrid` without
experts) as a middle pipeline stage of one decode token: no embedding, no
head; every layer's share of a deployment that divides each layer over
several provers by heads and MLP columns.

Each layer computes h = h + r * mixer(norm(h)), then h = h + r * mlp(norm(h)),
with r the residual multiplier, the mixer Mamba-2 (`nn.Mamba2Decode`) or
grouped-query attention without position embedding (`nn.GQADecode`) as
`layer_types` orders them, the MLP the shared SwiGLU.  Every mixer and MLP
gives the part of its output its held heads or columns make, and that part
goes on to the next layer: the all-reduce that would sum the parts is left
out.  The one exchange inside the equations, the gated norm's mean of
squares over every Mamba channel, enters as the input `norm_ssq_rest`.

The configuration is a dict of the model's config.json keys, with the
counts held here: `num_hidden_layers` and `layer_types` the stage's,
`num_attention_heads` and `mamba_n_heads` the heads held, `mlp_columns` the
MLP's columns held, `cached_positions` the KV cache's length and
`head_dim`.  A share's query heads start at a KV group's first head, so
its i-th reads its own i // group-th KV head.  `parameter_shapes(cfg)` lists every weight
as (fan_in, fan_out) in the order `build` reads the dict w1, b1, w2, ...:

    mamba:      norm (1, hidden); in_proj (hidden, z + xBC + dt columns);
                conv (d_conv, xBC channels) with its bias b; A_log (1, heads)
                with dt_bias b; D (1, heads); gated norm (1, inner);
                out_proj (inner, hidden)
    attention:  norm (1, hidden); q (hidden, heads * head_dim); k, v
                (hidden, kv heads * head_dim); o (heads * head_dim, hidden)
    both, then: norm (1, hidden); MLP in (hidden, gate + up columns);
                MLP out (columns, hidden)

Every other b is unused (the published layers have no other bias).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

from ..graph.graph import Graph, GraphTensor
from ..nn import GQADecode, Mamba2Decode, RMSNorm, SwiGLU


@dataclass(frozen=True)
class Sizes:
    hidden: int
    layer_types: Tuple[str, ...]
    heads: int  # attention query heads held
    head_dim: int
    kv_heads: int  # published
    mamba_heads: int  # held
    mamba_head_dim: int
    d_state: int
    d_conv: int
    mamba_channels: int  # every Mamba channel of a layer, over all shares: the gated norm's width
    mlp_columns: int  # held
    positions: int  # cached
    attention_multiplier: float
    residual_multiplier: float
    eps: float

    @staticmethod
    def of(cfg: dict) -> "Sizes":
        if cfg["mamba_n_groups"] != 1:
            raise ValueError("the Mamba-2 mixer takes one group of B and C")
        types = tuple(cfg["layer_types"])
        if len(types) != cfg["num_hidden_layers"]:
            raise ValueError(f"{len(types)} layer types for {cfg['num_hidden_layers']} layers")
        return Sizes(cfg["hidden_size"], types, cfg["num_attention_heads"], cfg["head_dim"],
                     cfg["num_key_value_heads"], cfg["mamba_n_heads"],
                     cfg["mamba_d_head"], cfg["mamba_d_state"], cfg["mamba_d_conv"],
                     cfg["mamba_expand"] * cfg["hidden_size"], cfg["mlp_columns"], cfg["cached_positions"],
                     cfg["attention_multiplier"], cfg["residual_multiplier"], cfg["rms_norm_eps"])

    @property
    def kv_of_head(self) -> List[int]:
        """Each held query head's KV head, among those held."""
        group = self.hidden // self.head_dim // self.kv_heads  # query heads a KV head serves
        return [i // group for i in range(self.heads)]

    @property
    def kv_held(self) -> int:
        """KV heads held: those the held query heads read."""
        return self.kv_of_head[-1] + 1

    @property
    def mamba_inner(self) -> int:
        return self.mamba_heads * self.mamba_head_dim

    @property
    def xbc_channels(self) -> int:
        return self.mamba_inner + 2 * self.d_state

    def count(self, kind: str) -> int:
        return self.layer_types.count(kind)

    def input_shapes(self) -> Dict[str, Tuple[int, ...]]:
        """The stage's inputs: each per-layer one stacked over its layers."""
        nm, na = self.count("mamba"), self.count("attention")
        cache = (na * self.kv_held, self.positions, self.head_dim)
        return {"hidden": (1, self.hidden), "k_cache": cache, "v_cache": cache,
                "ssm_state": (nm, self.mamba_heads, self.mamba_head_dim, self.d_state),
                "conv_state": (nm, self.xbc_channels, self.d_conv - 1), "norm_ssq_rest": (nm,)}


def parameter_shapes(cfg: dict) -> List[Tuple[int, int]]:
    s = Sizes.of(cfg)
    h, out = s.hidden, []
    for kind in s.layer_types:
        if kind == "mamba":
            out += [(1, h), (h, s.mamba_inner + s.xbc_channels + s.mamba_heads), (s.d_conv, s.xbc_channels),
                    (1, s.mamba_heads), (1, s.mamba_heads), (1, s.mamba_inner), (s.mamba_inner, h)]
        elif kind == "attention":
            q, kv = s.heads * s.head_dim, s.kv_held * s.head_dim
            out += [(1, h), (h, q), (h, kv), (h, kv), (q, h)]
        else:
            raise ValueError(f"unknown layer type {kind}")
        out += [(1, h), (h, 2 * s.mlp_columns), (s.mlp_columns, h)]
    return out


class Stacked:
    """A stage input stacked over layers: `set` gives each layer's tensor
    its slice of the leading axis."""

    def __init__(self, tensors: List[GraphTensor]):
        self.tensors = tensors

    def set(self, data) -> "Stacked":
        rows = np.asarray(data, dtype=np.float64).reshape(len(self.tensors), -1)
        for t, row in zip(self.tensors, rows):
            t.set(row)
        return self


def build(cx: Graph, cfg: dict, w: Dict[str, np.ndarray]) -> Tuple[Dict[str, Stacked], GraphTensor]:
    """The stage on `cx` with the weights `w` set: ({input name: tensor
    to `set`}, the retrieved final hidden state (1, hidden))."""
    s = Sizes.of(cfg)
    shapes = parameter_shapes(cfg)
    params = iter(range(1, len(shapes) + 1))

    def take():
        k = next(params)
        return np.asarray(w[f"w{k}"], dtype=np.float64), np.asarray(w[f"b{k}"], dtype=np.float64)

    h = cx.tensor((1, s.hidden))
    inputs = {name: [] for name in ("k_cache", "v_cache", "ssm_state", "conv_state", "norm_ssq_rest")}
    out = h
    for kind in s.layer_types:
        norm = RMSNorm(s.hidden, s.eps, cx)
        norm.weight.set(take()[0])
        if kind == "mamba":
            mixer = _mamba(cx, s, take)
            state = cx.tensor((s.mamba_heads, s.mamba_head_dim, s.d_state))
            conv = cx.tensor((s.xbc_channels, s.d_conv - 1))
            rest = cx.tensor((1,))
            inputs["ssm_state"].append(state)
            inputs["conv_state"].append(conv)
            inputs["norm_ssq_rest"].append(rest)
            part = mixer(norm(out), state, conv, rest)
        else:
            mixer = _attention(cx, s, take)
            ks = [cx.tensor((s.positions, s.head_dim)) for _ in range(s.kv_held)]
            vs = [cx.tensor((s.positions, s.head_dim)) for _ in range(s.kv_held)]
            inputs["k_cache"] += ks
            inputs["v_cache"] += vs
            part = mixer(norm(out), ks, vs)
        out = out + part * s.residual_multiplier
        post = RMSNorm(s.hidden, s.eps, cx)
        post.weight.set(take()[0])
        mlp = SwiGLU(s.hidden, s.mlp_columns, cx)
        w_in, _ = take()
        mlp.gate.weight.set(w_in[:, : s.mlp_columns])
        mlp.up.weight.set(w_in[:, s.mlp_columns :])
        mlp.down.weight.set(take()[0])
        out = out + mlp(post(out)) * s.residual_multiplier
    stacked = {name: Stacked(ts) for name, ts in inputs.items() if ts}
    return {"hidden": Stacked([h]), **stacked}, out.retrieve()


def _mamba(cx: Graph, s: Sizes, take) -> Mamba2Decode:
    m = Mamba2Decode(s.hidden, s.mamba_heads, s.mamba_head_dim, s.d_state, s.d_conv, s.mamba_channels, s.eps, cx)
    w_in, _ = take()
    inner, ch = s.mamba_inner, s.xbc_channels
    m.in_z.weight.set(w_in[:, :inner])
    m.in_xbc.weight.set(w_in[:, inner : inner + ch])
    m.in_dt.weight.set(w_in[:, inner + ch :])
    w_conv, b_conv = take()
    m.conv_weight.set(w_conv.T)
    m.conv_bias.set(b_conv)
    a_log, dt_bias = take()
    m.A_log.set(a_log[0])
    m.dt_bias.set(dt_bias)
    m.D.set(take()[0][0])
    m.norm.weight.set(take()[0])
    m.out_proj.weight.set(take()[0])
    return m


def _attention(cx: Graph, s: Sizes, take) -> GQADecode:
    a = GQADecode(s.hidden, s.kv_of_head, s.head_dim, s.positions, s.attention_multiplier, cx)
    hd = s.head_dim
    wq, wk, wv, wo = (take()[0] for _ in range(4))
    for i in range(s.heads):
        a.q[i].weight.set(wq[:, i * hd : (i + 1) * hd])
        a.o[i].weight.set(wo[i * hd : (i + 1) * hd])
    for j in range(s.kv_held):
        a.k[j].weight.set(wk[:, j * hd : (j + 1) * hd])
        a.v[j].weight.set(wv[:, j * hd : (j + 1) * hd])
    return a
