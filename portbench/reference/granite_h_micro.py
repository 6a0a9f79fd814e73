"""Plain reference of granite-4.0-h-micro's layers 10-19 (one decode token
at the configuration's share), in plain torch: the benchmark's own copy,
which imports nothing of the program.

(a) `forward_float32`: the published equations of HF `GraniteMoeHybrid`
    (no experts) in float32, at any share: each layer
    h = h + r * mixer(rms(h)), h = h + r * mlp(rms(h)), the mixer a
    Mamba-2 step or NoPE GQA attention over the cache and this token.
(b) `forward`: the same stage exactly as the proved graph computes it, in
    12-bit fixed point (a value v stands for v / 2^12): encodings round to
    nearest (half to even), products and reciprocals round toward zero,
    square roots are integer square roots of v * 2^12, exp2 and log2 are
    the lookup tables' values (float64 f of the fixed value, encoded
    again), each op in the graph's order; it also returns the rows each
    trace table gets (`fixed.Tape`, with the graph's merging of equal
    constants).

Departures from HF `GraniteMoeHybrid`:
- (a), (b): the share: each mixer and MLP gives the part of its output its
  held heads or columns make, and that part goes on to the next layer (the
  all-reduce of the parts is left out); the gated norm's sum of squares
  over the other shares' channels is the input `norm_ssq_rest`;
- (a), (b): one token against a cache (decode), no embedding, no head;
- (b): rms_norm_eps 1e-5 encodes to 0; residual_multiplier 0.22 to
  901 / 4096; attention_multiplier 1/64 exactly; each SiLU is
  x * recip(exp2(-x log2 e) + 1), softplus log2(exp2(x log2 e) + 1) ln 2;
  the softmax over n = cache + 1 positions normalises as
  e = exp2((s - max s) log2 e), p = e * recip(sum(e) * 2^-k),
  out = (p . v) * 2^-k with k = floor(log2 n) (products by 2^-7 and a
  last smaller power), because recip(sum(e)) alone truncates to 0 beyond
  2^12 positions.

Weights come as the benchmark's rule gives them: w1, b1, w2, ... in the
order the configuration's `layers` lists (fan_in, fan_out).
"""

from __future__ import annotations

import math
from typing import List

import numpy as np
import torch

from . import fixed as fx

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

SCALE_BITS = 12
SCALE = 1 << SCALE_BITS
_SAFE_MAX = float(1 << 62)
POW2_STEP = 7
LN2 = math.log(2.0)


# -- the configuration --------------------------------------------------------

def sizes(cfg: dict) -> dict:
    """The held sizes the stage is built from."""
    h, hd = cfg["hidden_size"], cfg["head_dim"]
    group = h // hd // cfg["num_key_value_heads"]
    nq = cfg["num_attention_heads"]
    kv_of = [i // group for i in range(nq)]  # a share's query heads start at a KV group's first
    nh, mhd, ds = cfg["mamba_n_heads"], cfg["mamba_d_head"], cfg["mamba_d_state"]
    return dict(hidden=h, types=list(cfg["layer_types"]), heads=nq, head_dim=hd, kv_of_head=kv_of,
                kv=kv_of[-1] + 1, mamba_heads=nh, mamba_head_dim=mhd, d_state=ds, d_conv=cfg["mamba_d_conv"],
                inner=nh * mhd, channels=nh * mhd + 2 * ds, total=cfg["mamba_expand"] * h,
                columns=cfg["mlp_columns"], positions=cfg["cached_positions"],
                attn_mult=cfg["attention_multiplier"], res_mult=cfg["residual_multiplier"],
                eps=cfg["rms_norm_eps"])


def layer_params(cfg: dict, weights: dict) -> List[dict]:
    """Each layer's named weights (float64 numpy) from w1, b1, ...."""
    s = sizes(cfg)
    k = 0

    def take():
        nonlocal k
        k += 1
        return np.asarray(weights[f"w{k}"], dtype=np.float64), np.asarray(weights[f"b{k}"], dtype=np.float64)

    out = []
    for kind in s["types"]:
        p = {"kind": kind, "norm": take()[0][0]}
        if kind == "mamba":
            inner, ch = s["inner"], s["channels"]
            w = take()[0]
            p.update(in_z=w[:, :inner], in_xbc=w[:, inner : inner + ch], in_dt=w[:, inner + ch :])
            w, b = take()
            p.update(conv_w=w.T, conv_b=b)
            w, b = take()
            p.update(A_log=w[0], dt_bias=b, D=take()[0][0], gnorm=take()[0][0], out_proj=take()[0])
        else:
            p.update(q=take()[0], k=take()[0], v=take()[0], o=take()[0])
        p.update(post_norm=take()[0][0])
        w = take()[0]
        p.update(gate=w[:, : s["columns"]], up=w[:, s["columns"] :], down=take()[0])
        out.append(p)
    return out


def _per_layer(inputs: dict, name: str, n: int) -> np.ndarray:
    return np.asarray(inputs[name], dtype=np.float64).reshape(n, -1) if n else None


# -- (a) float32 ----------------------------------------------------------------

def _t(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), dtype=torch.float32)


def _source(tape, kind: str, x: torch.Tensor) -> torch.Tensor:
    """Notes on `tape` (when given) the source of a lookup the fixed-point
    graph makes at this point, as these float32 values encode."""
    if tape is not None:
        v = encode(x.double())
        tape.lut_sources[kind].append(np.array([int(v.min()), int(v.max())], dtype=np.int64))
    return x


def _exp(x: torch.Tensor, tape=None) -> torch.Tensor:
    _source(tape, "exp2", x / LN2)
    return torch.exp(x)


def _silu(x: torch.Tensor, tape=None) -> torch.Tensor:
    _source(tape, "exp2", -x / LN2)
    return torch.nn.functional.silu(x)


def _softplus(x: torch.Tensor, tape=None) -> torch.Tensor:
    _source(tape, "log2", _exp(x, tape) + 1)
    return torch.nn.functional.softplus(x)


def rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def mamba_mixer(s: dict, p: dict, h: torch.Tensor, ssm_state: torch.Tensor, conv_state: torch.Tensor,
                ssq_rest: float, tape=None):
    """One token through the held Mamba-2 heads (HF torch_forward's cached
    step): (their part of out_proj (1, hidden), their sum of squares of the
    gated norm's input)."""
    nh, hd, ds, inner = s["mamba_heads"], s["mamba_head_dim"], s["d_state"], s["inner"]
    xbc = h @ _t(p["in_xbc"])  # (1, channels)
    window = torch.cat([conv_state, xbc.T], 1)  # (channels, d_conv)
    xbc = _silu((window * _t(p["conv_w"])).sum(1) + _t(p["conv_b"]), tape)
    x, B, C = xbc[:inner].reshape(nh, hd), xbc[inner : inner + ds], xbc[inner + ds :]
    dt = _softplus((h @ _t(p["in_dt"]))[0] + _t(p["dt_bias"]), tape)
    dA = _exp(dt * -_exp(_t(p["A_log"]), tape), tape)
    state = ssm_state * dA[:, None, None] + (dt[:, None, None] * B[None, None, :]) * x[:, :, None]
    y = (state @ C) + x * _t(p["D"])[:, None]
    g = y.reshape(1, inner) * _silu(h @ _t(p["in_z"]), tape)
    ssq = g.pow(2).sum()
    normed = g * torch.rsqrt((ssq + ssq_rest) / s["total"] + s["eps"]) * _t(p["gnorm"])
    return normed @ _t(p["out_proj"]), ssq


def attention_mixer(s: dict, p: dict, h: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor, tape=None):
    """One token of NoPE GQA over the cache (kv, positions, head_dim) and
    itself, for the held query heads: their part of o_proj (1, hidden)."""
    hd = s["head_dim"]
    q = (h @ _t(p["q"])).reshape(-1, hd)
    k = torch.cat([k_cache, (h @ _t(p["k"])).reshape(-1, 1, hd)], 1)
    v = torch.cat([v_cache, (h @ _t(p["v"])).reshape(-1, 1, hd)], 1)
    outs = []
    for i, j in enumerate(s["kv_of_head"]):
        scores = (k[j] @ q[i]) * s["attn_mult"]
        _source(tape, "exp2", (scores - scores.max()) / LN2)
        if tape is not None:
            tape.range_check = True  # the graph's max_reduce
        outs.append(torch.softmax(scores, 0) @ v[j])
    return torch.cat(outs).reshape(1, -1) @ _t(p["o"])


def mlp(p: dict, x: torch.Tensor, tape=None) -> torch.Tensor:
    return (_silu(x @ _t(p["gate"]), tape) * (x @ _t(p["up"]))) @ _t(p["down"])


def float32_hidden(cfg: dict, weights: dict, inputs: dict, tape=None) -> torch.Tensor:
    """The stage's final hidden state (1, hidden), float32; with `tape`,
    each lookup's source as these values give it."""
    s = sizes(cfg)
    nm, na = s["types"].count("mamba"), s["types"].count("attention")
    states = _per_layer(inputs, "ssm_state", nm)
    convs = _per_layer(inputs, "conv_state", nm)
    rests = _per_layer(inputs, "norm_ssq_rest", nm)
    kc = _per_layer(inputs, "k_cache", na)
    vc = _per_layer(inputs, "v_cache", na)
    h = _t(inputs["hidden"]).reshape(1, s["hidden"])
    im = ia = 0
    for p in layer_params(cfg, weights):
        x = rms(h, _t(p["norm"]), s["eps"])
        if p["kind"] == "mamba":
            part, _ = mamba_mixer(s, p, x, _t(states[im]).reshape(s["mamba_heads"], s["mamba_head_dim"], -1),
                                  _t(convs[im]).reshape(s["channels"], -1), float(rests[im][0]), tape)
            im += 1
        else:
            shape = (s["kv"], s["positions"], s["head_dim"])
            part = attention_mixer(s, p, x, _t(kc[ia]).reshape(shape), _t(vc[ia]).reshape(shape), tape)
            ia += 1
        h = h + part * s["res_mult"]
        h = h + mlp(p, rms(h, _t(p["post_norm"]), s["eps"]), tape) * s["res_mult"]
    return h


# -- (b) the fixed point of the proved graph ---------------------------------------

def encode(x) -> torch.Tensor:
    """float64 -> raw: x * 2^12 rounded half to even, NaN 0, saturated at +-2^62."""
    scaled = torch.round(torch.as_tensor(x, dtype=torch.float64) * SCALE)
    scaled = torch.nan_to_num(scaled, nan=0.0, posinf=_SAFE_MAX, neginf=-_SAFE_MAX)
    return torch.clamp(scaled, -_SAFE_MAX, _SAFE_MAX).to(torch.int64)


def decode(v: torch.Tensor) -> torch.Tensor:
    return v.to(torch.float64) / SCALE


class Fixed:
    """The graph's primitives on raw int64 tensors, each counted on the tape."""

    def __init__(self, tape):
        self.tape = tape

    def input(self, x) -> torch.Tensor:
        v = encode(torch.as_tensor(np.asarray(x, dtype=np.float64)))
        self.tape.op("inputs", v.numel())
        return v

    def mul(self, a, b) -> torch.Tensor:
        p = a * b
        self.tape.op("mul", p.numel())
        return torch.div(p, SCALE, rounding_mode="trunc")

    def _const(self, c: float) -> torch.Tensor:
        return torch.as_tensor(np.asarray(self.tape.const(c)), dtype=torch.int64)

    def cmul(self, a, c: float) -> torch.Tensor:
        return self.mul(a, self._const(c))

    def add(self, a, b) -> torch.Tensor:
        out = a + b
        self.tape.op("add", out.numel())
        return out

    def cadd(self, a, c: float) -> torch.Tensor:
        return self.add(a, self._const(c))

    def square(self, a) -> torch.Tensor:
        self.tape.op("square", a.numel())
        return torch.div(a * a, SCALE, rounding_mode="trunc")

    def recip(self, a) -> torch.Tensor:
        self.tape.op("recip", a.numel())
        safe = torch.where(a == 0, torch.ones_like(a), a)
        return torch.where(a == 0, torch.zeros_like(a), torch.div(torch.full_like(a, SCALE * SCALE), safe,
                                                                  rounding_mode="trunc"))

    def sqrt(self, a) -> torch.Tensor:
        self.tape.op("sqrt", a.numel())
        x = torch.clamp(a * SCALE, min=0)
        out = torch.sqrt(x.to(torch.float64)).to(torch.int64)
        out = torch.where((out + 1) * (out + 1) <= x, out + 1, out)
        return torch.where(out * out > x, out - 1, out)

    def sum(self, a, dim: int) -> torch.Tensor:
        self.tape.op("sum_reduce", a.numel())
        return a.sum(dim)

    def max(self, a, dim: int) -> torch.Tensor:
        self.tape.op("max_reduce", a.numel())
        self.tape.range_check = True
        return a.max(dim).values

    def contiguous(self, a, source_len: int) -> torch.Tensor:
        """A slice or pad materialised: its rows consume the whole source."""
        self.tape.op("contiguous", max(source_len, a.numel()))
        return a

    def _lut(self, kind: str, a, fn) -> torch.Tensor:
        self.tape.op(kind, a.numel())
        self.tape.lut_sources[kind].append(np.array([int(a.min()), int(a.max())], dtype=np.int64))
        return encode(torch.from_numpy(fn(decode(a).numpy())))

    def exp2(self, a) -> torch.Tensor:
        return self._lut("exp2", a, np.exp2)

    def log2(self, a) -> torch.Tensor:
        return self._lut("log2", a, lambda x: np.log2(np.maximum(x, 1e-300)))

    # composed as the graph composes them
    def exp(self, a):
        return self.exp2(self.cmul(a, 1.0 / LN2))

    def silu(self, a):
        sig = self.recip(self.cadd(self.exp(self.cmul(a, -1.0)), 1.0))
        return self.mul(a, sig)

    def softplus(self, a):
        return self.cmul(self.log2(self.cadd(self.exp(a), 1.0)), LN2)

    def scale_pow2(self, a, shift: int):
        while shift > 0:
            step = min(shift, POW2_STEP)
            a = self.cmul(a, 2.0**-step)
            shift -= step
        return a

    def matmul(self, x, w):
        """(1, k) @ (k, n): a product a row and column, then the sum over k."""
        return self.sum(self.mul(x.reshape(1, 1, -1), w.T.unsqueeze(0)), 2)

    def linear(self, x, w: np.ndarray):
        return self.matmul(x, self.input(w))

    def rms(self, x, w: np.ndarray, eps: float):
        n = x.shape[-1]
        mean = self.cadd(self.cmul(self.sum(self.square(x), 1), 1.0 / n), eps)
        r = self.recip(self.sqrt(mean))
        return self.mul(self.mul(x, r[:, None]), self.input(w)[None, :])


def _mamba_fixed(F: Fixed, s: dict, p: dict, h, ssm_state, conv_state, ssq_rest):
    nh, hd, ds, inner, ch = s["mamba_heads"], s["mamba_head_dim"], s["d_state"], s["inner"], s["channels"]
    new = F.linear(h, p["in_xbc"])  # (1, channels)
    state_in = F.input(conv_state).reshape(ch, -1)
    taps = state_in.shape[1] + 1
    window = F.add(F.contiguous(torch.cat([state_in, torch.zeros(ch, 1, dtype=torch.int64)], 1), state_in.numel()),
                   F.contiguous(torch.cat([torch.zeros(ch, taps - 1, dtype=torch.int64), new.T], 1), ch))
    xbc = F.silu(F.add(F.sum(F.mul(window, F.input(p["conv_w"])), 1), F.input(p["conv_b"])))
    x = F.contiguous(xbc[:inner], ch).reshape(nh, hd)
    B = F.contiguous(xbc[inner : inner + ds], ch)
    C = F.contiguous(xbc[inner + ds :], ch)
    dt = F.softplus(F.add(F.linear(h, p["in_dt"]).reshape(nh), F.input(p["dt_bias"])))
    dA = F.exp(F.mul(dt, F.cmul(F.exp(F.input(p["A_log"])), -1.0)))
    dBx = F.mul(F.mul(x, dt[:, None].expand(nh, hd))[:, :, None].expand(nh, hd, ds), B.expand(nh, hd, ds))
    state = F.add(F.mul(F.input(ssm_state).reshape(nh, hd, ds), dA[:, None, None].expand(nh, hd, ds)), dBx)
    y = F.add(F.sum(F.mul(state, C.expand(nh, hd, ds)), 2), F.mul(x, F.input(p["D"])[:, None].expand(nh, hd)))
    z = F.linear(h, p["in_z"])
    g = F.mul(y.reshape(1, inner), F.silu(z))
    ssq = F.add(F.sum(F.square(g), 1), F.input(np.reshape(ssq_rest, 1)))
    mean = F.cadd(F.cmul(ssq, 1.0 / s["total"]), s["eps"])
    r = F.recip(F.sqrt(mean))
    normed = F.mul(F.mul(g, r[:, None].expand(1, inner)), F.input(p["gnorm"])[None, :])
    return F.linear(normed, p["out_proj"])


def _attention_fixed(F: Fixed, s: dict, p: dict, h, k_cache, v_cache):
    n, hd = s["positions"], s["head_dim"]
    shift = (n + 1).bit_length() - 1  # floor(log2) of the positions the softmax runs over
    k_new = [F.linear(h, p["k"][:, j * hd : (j + 1) * hd]) for j in range(s["kv"])]
    v_new = [F.linear(h, p["v"][:, j * hd : (j + 1) * hd]) for j in range(s["kv"])]
    ks = [F.input(c).reshape(n, hd) for c in k_cache]
    vs = [F.input(c).reshape(n, hd) for c in v_cache]
    out = None
    for i, j in enumerate(s["kv_of_head"]):
        q = F.linear(h, p["q"][:, i * hd : (i + 1) * hd])  # (1, head_dim)
        s_cache = F.matmul(q, ks[j].T)  # (1, positions)
        s_new = F.sum(F.mul(q, k_new[j]), 1).reshape(1, 1)
        zero = torch.zeros(1, 1, dtype=torch.int64)
        scores = F.add(F.contiguous(torch.cat([s_cache, zero], 1), n),
                       F.contiguous(torch.cat([torch.zeros(1, n, dtype=torch.int64), s_new], 1), 1))
        scores = F.cmul(scores, s["attn_mult"])
        neg_max = F.cmul(F.max(scores, 1), -1.0)
        e = F.exp(F.add(scores, neg_max[:, None].expand(1, n + 1)))
        r = F.recip(F.scale_pow2(F.sum(e, 1), shift))
        prob = F.mul(e, r[:, None].expand(1, n + 1))  # 2^shift * softmax
        p_new = F.contiguous(prob[:, n:], n + 1).expand(1, hd)
        o = F.add(F.matmul(F.contiguous(prob[:, :n], n + 1), vs[j]), F.mul(p_new, v_new[j]))
        part = F.linear(F.scale_pow2(o, shift), p["o"][i * hd : (i + 1) * hd])
        out = part if out is None else F.add(out, part)
    return out


def forward_raw(cfg: dict, weights: dict, inputs: dict, tape=None):
    """(raw int64 final hidden state (1, hidden), the tape of its rows)."""
    tape = fx.Tape() if tape is None else tape
    F = Fixed(tape)
    s = sizes(cfg)
    nm, na = s["types"].count("mamba"), s["types"].count("attention")
    states = _per_layer(inputs, "ssm_state", nm)
    convs = _per_layer(inputs, "conv_state", nm)
    rests = _per_layer(inputs, "norm_ssq_rest", nm)
    kc = _per_layer(inputs, "k_cache", na * s["kv"])
    vc = _per_layer(inputs, "v_cache", na * s["kv"])
    h = F.input(inputs["hidden"]).reshape(1, s["hidden"])
    im = ia = 0
    for p in layer_params(cfg, weights):
        x = F.rms(h, p["norm"], s["eps"])
        if p["kind"] == "mamba":
            part = _mamba_fixed(F, s, p, x, states[im], convs[im], rests[im])
            im += 1
        else:
            kv = slice(ia * s["kv"], (ia + 1) * s["kv"])
            part = _attention_fixed(F, s, p, x, kc[kv], vc[kv])
            ia += 1
        h = F.add(h, F.cmul(part, s["res_mult"]))
        h = F.add(h, F.cmul(_mlp_fixed(F, p, F.rms(h, p["post_norm"], s["eps"])), s["res_mult"]))
    return h, tape


def _mlp_fixed(F: Fixed, p: dict, x):
    return F.linear(F.mul(F.silu(F.linear(x, p["gate"])), F.linear(x, p["up"])), p["down"])


def forward(cfg: dict, weights: dict, inputs: dict):
    """(raw int64 outputs (1, hidden), tape): the fixed-point pass."""
    with torch.no_grad():
        raw, tape = forward_raw(cfg, weights, inputs)
    return raw.numpy(), tape


def forward_float32(cfg: dict, weights: dict, inputs: dict):
    """The control: the stage in float32; (its outputs encoded in fixed
    point, a tape holding each lookup's source as float32 gives it)."""
    tape = fx.Tape()
    with torch.no_grad():
        h = float32_hidden(cfg, weights, inputs, tape)
    return fx.from_float(h.double().numpy()), tape
