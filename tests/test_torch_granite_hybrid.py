"""granite-4.0-h-micro's hybrid stage (models/granite_hybrid.py) on the CPU,
against the benchmark's plain reference of it
(portbench/reference/granite_h_micro.py), at the smallest size that still
has every component: hidden 16, 2 attention heads of 8 with 1 KV head, 4
Mamba-2 heads of 4 with d_state 4 and d_conv 4, MLP 16, the layers mamba
and attention, a cache of 8, each layer over 2 shares (this one holds
attention head 0, Mamba heads 0-1, MLP columns 0-7).  Every op table has
at most 2^12 rows; the exp2 lookup table covers the range of the values
its sources take, which the widths do not set.

The port's output equals the reference's fixed point exactly, and its trace
tables the rows the reference's tape counts; the fixed point agrees with
the float32 equations within a tolerance; the graph's softmax in the plain
order loses the probabilities at 4,096 positions; the shares add up to the
uncut layers; the stage proves and verifies.  The new graph ops and nn
modules each agree with float32."""

import ast
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from luminair_tpu_torch import prelude as T
from luminair_tpu_torch import tracing
from luminair_tpu_torch.graph.graph import concat
from luminair_tpu_torch.models import granite_hybrid as gh
from luminair_tpu_torch.nn import GatedRMSNorm, Mamba2Decode, RMSNorm
from portbench import checks
from portbench.reference import granite_h_micro as ref

ROOT = Path(__file__).resolve().parent.parent
STEP = 2.0**-12
CFG = dict(hidden_size=16, head_dim=8, num_attention_heads=1, num_key_value_heads=1, mamba_n_heads=2,
           mamba_d_head=4, mamba_d_state=4, mamba_d_conv=4, mamba_expand=1, mamba_n_groups=1, mlp_columns=8,
           cached_positions=8, attention_multiplier=0.015625, residual_multiplier=0.22, rms_norm_eps=1e-5,
           layer_types=["mamba", "attention"], num_hidden_layers=2)
UNCUT = dict(CFG, num_attention_heads=2, mamba_n_heads=4, mlp_columns=16)
PCS = T.PcsConfig(pow_bits=1, fri=T.FriConfig(log_blowup_factor=1, log_last_layer_degree_bound=0, n_queries=3))


def weights(cfg, seed):
    """w_k normal with scale 1/sqrt(fan_in), b_k zero, in parameter_shapes' order."""
    rng = np.random.default_rng(seed)
    w = {}
    for k, (fan_in, fan_out) in enumerate(gh.parameter_shapes(cfg), start=1):
        w[f"w{k}"] = rng.normal(size=(fan_in, fan_out)) / np.sqrt(fan_in)
        w[f"b{k}"] = np.zeros(fan_out)
    return w


def inputs(cfg, seed):
    rng = np.random.default_rng(seed + 1000)
    shapes = gh.Sizes.of(cfg).input_shapes()
    out = {k: rng.normal(size=shape) for k, shape in shapes.items()}
    out["norm_ssq_rest"] = rng.uniform(5.0, 15.0, size=shapes["norm_ssq_rest"])
    return out


def run_port(cfg, w, x, prove=False):
    cx = T.Graph()
    ins, out = gh.build(cx, cfg, w)
    for name, v in x.items():
        ins[name].set(v)
    cx.compile()
    settings = T.gen_circuit_settings(cx, device="cpu")
    pie = T.gen_trace(cx, settings, device="cpu")
    proof = T.prove(pie, settings, PCS, device="cpu") if prove else None
    return out.data(), pie, settings, proof


def decoded(raw):
    return ref.decode(torch.as_tensor(raw))


@pytest.fixture(scope="module")
def stage():
    """The port's pass and the reference's over seed 1, proved."""
    w, x = weights(CFG, 1), inputs(CFG, 1)
    got, pie, settings, proof = run_port(CFG, w, x, prove=True)
    raw, tape = ref.forward(CFG, w, x)
    return got, pie, settings, proof, raw, tape


# both query heads, each reading its own KV head (2 KV heads held)
TWO_KV = dict(CFG, num_attention_heads=2, num_key_value_heads=2)


@pytest.mark.parametrize("seed,cfg", [(1, CFG), (2, CFG), (3, CFG), (4, TWO_KV)], ids=["1", "2", "3", "two_kv"])
def test_port_output_equals_the_fixed_point_reference(seed, cfg):
    """(a) The retrieved hidden state, value for value."""
    w, x = weights(cfg, seed), inputs(cfg, seed)
    got = run_port(cfg, w, x)[0]
    raw, _ = ref.forward(cfg, w, x)
    np.testing.assert_array_equal(got.reshape(-1), decoded(raw).numpy().reshape(-1))


def test_trace_tables_have_the_rows_the_reference_counts(stage):
    """(e) Every trace table, the lookups' padded to their log size, as the
    benchmark's statement has them."""
    _, pie, *_, tape = stage
    rows = {n: t.n_rows for n, t in pie.trace_tables.items()}
    assert rows == checks.statement_of(tape).rows
    assert max(n for name, n in rows.items() if not name.endswith("_lookup")) <= 1 << 12


def test_the_stage_proves_and_verifies_on_the_cpu(stage):
    """(d) Every component the stage uses in one proof."""
    _, pie, settings, proof, *_ = stage
    assert {"max_reduce", "sqrt", "log2", "log2_lookup", "range_check_lookup", "square"} <= set(pie.trace_tables)
    assert T.verify(proof, settings, device="cpu")


# A sum of L products, each truncated by under one step (2^-12) and rounded
# both ways across signs, is off by about sqrt(L) / 2 steps; the stage's
# sums are of at most 16 terms (4,096 in the attention's, whose
# probabilities are scaled by 2^12), two layers deep, with norms'
# reciprocals between them: 8 steps of root-mean-square error over the
# outputs.
RMS_TOL = 8 * STEP


def _rms_error(cfg, seed):
    w, x = weights(cfg, seed), inputs(cfg, seed)
    raw, _ = ref.forward(cfg, w, x)
    f32 = ref.float32_hidden(cfg, w, x)
    return float((decoded(raw) - f32.double()).pow(2).mean().sqrt())


@pytest.mark.parametrize("cache", [8, 4095])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_fixed_point_agrees_with_float32(seed, cache):
    """(b) Within RMS_TOL at 9 positions and at 4,096."""
    assert _rms_error(dict(CFG, cached_positions=cache), seed) <= RMS_TOL


# Total variation of the graph's softmax (shifted back by 2^-shift) from
# torch.softmax over 4,096 scores of unit scale: each e is rounded by half a
# step, which moves p by 2^-13 / sum(e) and the total by 2^-13 / mean(e),
# at most 2^-8 while mean(e) >= 1/32; the reciprocal's and the product's
# truncations add at most 2 steps of 2^12 p each, 2^-11 over the row.
SOFTMAX_TOL = 2.0**-7


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_a_plain_softmax_at_4096_positions_loses_the_probabilities(seed):
    """(b) The graph's softmax in the order the attention takes it
    (shift 12 = floor(log2 4096)) keeps within SOFTMAX_TOL; the plain
    e * recip(sum(e)) (shift 0) does not: the reciprocal of a sum of
    hundreds truncates to a few raw steps, and most probabilities to 0."""
    x = np.random.default_rng(seed).normal(size=(1, 4096))
    want = torch.softmax(torch.tensor(x, dtype=torch.float32), 1).double().numpy()

    def total_variation(shift):
        cx = T.Graph()
        out = cx.tensor((1, 4096)).set(x).softmax(1, shift).retrieve()
        cx.compile()
        T.gen_trace(cx, T.gen_circuit_settings(cx, device="cpu"), device="cpu")
        return float(np.abs(out.data() * 2.0**-shift - want).sum())

    assert total_variation(12) <= SOFTMAX_TOL < total_variation(0)


# -- the share -------------------------------------------------------------

UNCUT_SIZES, HELD = ref.sizes(UNCUT), ref.sizes(CFG)


def _uncut_layer(seed):
    """One layer's uncut float32 weights, named as layer_params names them."""
    s = UNCUT_SIZES
    h, inner, ds, nh, hd, cols = s["hidden"], s["inner"], s["d_state"], s["mamba_heads"], s["head_dim"], s["columns"]
    taps = s["d_conv"]
    rng = np.random.default_rng(seed)

    def n(*shape):
        return rng.normal(size=shape) / np.sqrt(shape[0])

    return {"in_z": n(h, inner), "in_x": n(h, inner), "in_bc": n(h, 2 * ds), "in_dt": n(h, nh),
            "conv_x": rng.normal(size=(inner, taps)), "conv_bc": rng.normal(size=(2 * ds, taps)),
            "bias_x": rng.normal(size=inner), "bias_bc": rng.normal(size=2 * ds), "A_log": rng.normal(size=nh),
            "dt_bias": rng.normal(size=nh), "D": rng.normal(size=nh), "gnorm": rng.normal(size=inner),
            "out_proj": n(inner, h), "q": n(h, s["heads"] * hd), "k": n(h, hd), "v": n(h, hd),
            "o": n(s["heads"] * hd, h), "gate": n(h, cols), "up": n(h, cols), "down": n(cols, h)}


def _held(u, i, parts):
    """Share i of `parts` of the uncut weights `u`: its heads' and columns'
    slices, and B and C whole."""
    s = UNCUT_SIZES
    inner, nh, hd, cols = s["inner"] // parts, s["mamba_heads"] // parts, s["head_dim"], s["columns"] // parts
    x = slice(i * inner, (i + 1) * inner)
    heads = slice(i * nh, (i + 1) * nh)
    c = slice(i * cols, (i + 1) * cols)
    q = slice(i * hd * s["heads"] // parts, (i + 1) * hd * s["heads"] // parts)
    return {"in_z": u["in_z"][:, x], "in_xbc": np.concatenate([u["in_x"][:, x], u["in_bc"]], 1),
            "in_dt": u["in_dt"][:, heads], "conv_w": np.concatenate([u["conv_x"][x], u["conv_bc"]]),
            "conv_b": np.concatenate([u["bias_x"][x], u["bias_bc"]]), "A_log": u["A_log"][heads],
            "dt_bias": u["dt_bias"][heads], "D": u["D"][heads], "gnorm": u["gnorm"][x],
            "out_proj": u["out_proj"][x], "q": u["q"][:, q], "k": u["k"], "v": u["v"], "o": u["o"][q],
            "gate": u["gate"][:, c], "up": u["up"][:, c], "down": u["down"][c]}


@pytest.mark.parametrize("kind", ["mamba", "attention", "mlp"])
@pytest.mark.parametrize("seed", [1, 2])
def test_the_shares_add_up_to_the_uncut_layer(kind, seed):
    """(c) Each share's part, with B and C computed alike by both (counted
    once: they enter no sum) and norm_ssq_rest fed the other share's own
    sum of squares, adds up to the uncut float32 layer."""
    s = UNCUT_SIZES
    u = _uncut_layer(seed)
    rng = np.random.default_rng(seed + 7)

    def t(*shape):
        return torch.tensor(rng.normal(size=shape), dtype=torch.float32)

    h = t(1, s["hidden"])
    state = t(s["mamba_heads"], s["mamba_head_dim"], s["d_state"])
    conv = t(s["channels"], s["d_conv"] - 1)
    kc, vc = t(1, s["positions"], s["head_dim"]), t(1, s["positions"], s["head_dim"])

    def part(sz, p, i, rest=0.0):
        if kind == "mamba":
            inner, nh = sz["inner"], sz["mamba_heads"]
            cv = torch.cat([conv[i * inner : (i + 1) * inner], conv[s["inner"] :]])
            return ref.mamba_mixer(sz, p, h, state[i * nh : (i + 1) * nh], cv, rest)
        if kind == "attention":
            return ref.attention_mixer(sz, p, h, kc, vc), None
        return ref.mlp(p, h), None

    whole, _ = part(s, _held(u, 0, 1), 0)
    if kind == "mamba":
        own = [part(HELD, _held(u, i, 2), i)[1] for i in range(2)]
        parts = [part(HELD, _held(u, i, 2), i, float(own[1 - i]))[0] for i in range(2)]
    else:
        parts = [part(HELD, _held(u, i, 2), i)[0] for i in range(2)]
    torch.testing.assert_close(parts[0] + parts[1], whole, rtol=1e-5, atol=1e-5)


# -- the graph ops and nn modules, one at a time -----------------------------


def _graph_case(name, rng):
    """(build(cx) -> retrieved tensor, float32 value) for one op or module."""
    x = rng.normal(size=(1, 32))
    f = torch.tensor(x, dtype=torch.float32)
    if name == "silu":
        return lambda cx: cx.tensor((1, 32)).set(x).silu(), torch.nn.functional.silu(f)
    if name == "softplus":
        return lambda cx: cx.tensor((1, 32)).set(x).softplus(), torch.nn.functional.softplus(f)
    if name == "softmax":
        return lambda cx: cx.tensor((1, 32)).set(x).softmax(1, 5), torch.softmax(f, 1) * 32
    if name == "concat":
        y = rng.normal(size=(1, 8))
        return (lambda cx: concat([cx.tensor((1, 32)).set(x), cx.tensor((1, 8)).set(y)], 1),
                torch.cat([f, torch.tensor(y, dtype=torch.float32)], 1))
    w = rng.normal(size=32)
    if name == "rms_norm":
        def build(cx):
            m = RMSNorm(32, 1e-5, cx)
            m.weight.set(w)
            return m(cx.tensor((1, 32)).set(x))
        return build, ref.rms(f, torch.tensor(w, dtype=torch.float32), 1e-5)
    if name == "gated_rms_norm":
        z, rest = rng.normal(size=(1, 32)), 40.0

        def build(cx):
            m = GatedRMSNorm(32, 64, 1e-5, cx)
            m.weight.set(w)
            return m(cx.tensor((1, 32)).set(x), cx.tensor((1, 32)).set(z), cx.tensor((1,)).set([rest]))
        g = f * torch.nn.functional.silu(torch.tensor(z, dtype=torch.float32))
        return build, g * torch.rsqrt((g.pow(2).sum() + rest) / 64 + 1e-5) * torch.tensor(w, dtype=torch.float32)
    # the Mamba-2 step: the held heads of CFG, weights as layer_params gives them
    s = HELD
    nh, hd, ds, hidden = s["mamba_heads"], s["mamba_head_dim"], s["d_state"], s["hidden"]
    p = ref.layer_params(CFG, weights(CFG, int(rng.integers(100))))[0]
    h = rng.normal(size=(1, hidden))
    state, conv, rest = rng.normal(size=(nh, hd, ds)), rng.normal(size=(s["channels"], s["d_conv"] - 1)), 20.0

    def build(cx):
        m = Mamba2Decode(hidden, nh, hd, ds, s["d_conv"], s["total"], 1e-5, cx)
        m.in_z.weight.set(p["in_z"])
        m.in_xbc.weight.set(p["in_xbc"])
        m.in_dt.weight.set(p["in_dt"])
        m.conv_weight.set(p["conv_w"])
        m.conv_bias.set(p["conv_b"])
        m.A_log.set(p["A_log"])
        m.dt_bias.set(p["dt_bias"])
        m.D.set(p["D"])
        m.norm.weight.set(p["gnorm"])
        m.out_proj.weight.set(p["out_proj"])
        return m(cx.tensor((1, hidden)).set(h), cx.tensor(state.shape).set(state), cx.tensor(conv.shape).set(conv),
                 cx.tensor((1,)).set([rest]))
    want, _ = ref.mamba_mixer(s, p, torch.tensor(h, dtype=torch.float32), torch.tensor(state, dtype=torch.float32),
                              torch.tensor(conv, dtype=torch.float32), rest)
    return build, want


# Each case's tolerance, in steps of 2^-12: one truncation a product and a
# LUT's rounding for the activations; sums of 32 truncated terms for the
# norms; the Mamba step's sums of up to 32 products, a norm's reciprocal and
# an out-projection over 8 channels.
CASES = {"silu": 2, "softplus": 3, "softmax": 2, "concat": 0, "rms_norm": 16, "gated_rms_norm": 16, "mamba2_step": 48}


@pytest.mark.parametrize("name", sorted(CASES))
def test_a_graph_op_or_module_agrees_with_float32(name):
    build, want = _graph_case(name, np.random.default_rng(sorted(CASES).index(name) + 5))
    cx = T.Graph()
    out = build(cx).retrieve()
    cx.compile()
    T.gen_trace(cx, T.gen_circuit_settings(cx, device="cpu"), device="cpu")
    got = out.data().reshape(-1)
    # the inputs' own encoding (half a step each) passes through, so one step more
    tol = (CASES[name] + 1) * STEP * max(1.0, float(want.abs().max()))
    np.testing.assert_allclose(got, want.double().numpy().reshape(-1), atol=tol, rtol=0)


# -- the repeat counter ------------------------------------------------------


def test_h2d_repeat_counts_inputs_not_set_since_the_last_pass():
    """Each pass counts 8 bytes a value of the input tensors it stages
    though they were not set since the graph's previous pass: 0 while the
    graph's resident encoding holds (it stages only what was set since),
    every such input where the record lies on another device."""
    rng = np.random.default_rng(3)
    cx = T.Graph()
    a, b = cx.tensor((4, 8)), cx.tensor((8,))
    (a * b.expand_to((4, 8)) + a).retrieve()
    cx.compile()

    def repeated(elsewhere=False):
        if elsewhere:  # the graph's last pass on another device
            cx.resident.values = cx.resident.values.to("meta")
        before = tracing.since_reset(tracing.H2D_REPEAT)
        T.gen_circuit_settings(cx, device="cpu")
        return tracing.since_reset(tracing.H2D_REPEAT) - before

    a.set(rng.normal(size=(4, 8)))
    b.set(rng.normal(size=8))
    assert repeated() == 0
    assert repeated() == 0
    assert repeated(elsewhere=True) == 8 * (32 + 8)
    a.set(rng.normal(size=(4, 8)))
    assert repeated() == 0
    a.set(rng.normal(size=(4, 8)))
    assert repeated(elsewhere=True) == 8 * 8
    a.set(rng.normal(size=(4, 8)))
    b.set(rng.normal(size=8))
    assert repeated(elsewhere=True) == 0
    q = tracing.requests()[-1]
    assert q.counters()[tracing.H2D_REPEAT] == 0
    assert [s.path for s in q.spans if tracing.H2D_REPEAT in s.counts] == ["settings/upload"]


# -- the reference stands alone ------------------------------------------------

REFERENCES = [ROOT / "portbench" / "reference" / "granite_h_micro.py", ROOT / "portbench" / "reference" / "fixed.py"]
ALLOWED = {"__future__", "math", "collections", "typing", "numpy", "torch"}


@pytest.mark.parametrize("path", REFERENCES, ids=lambda p: p.name)
def test_the_reference_imports_plain_torch_and_numpy_only(path):
    """No JAX, nothing of luminair_tpu and nothing of the port: the
    reference, and the benchmark's fixed point, the one module it imports
    beside them."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            assert {a.name.split(".")[0] for a in node.names} <= ALLOWED, ast.dump(node)
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                assert node.module is None and [a.name for a in node.names] == ["fixed"], ast.dump(node)
            else:
                assert node.module.split(".")[0] in ALLOWED, ast.dump(node)
    if path.name == "granite_h_micro.py":
        assert "allow_tf32 = False" in path.read_text()


def test_the_configuration_file_lists_the_stages_parameters():
    cfg = json.loads((ROOT / "portbench" / "configs" / "granite_h_micro.json").read_text())
    assert [tuple(x) for x in cfg["layers"]] == gh.parameter_shapes(cfg)
    shapes = gh.Sizes.of(cfg).input_shapes()
    assert {k: math.prod(v["shape"]) for k, v in cfg["inputs"].items()} == {
        k: math.prod(v) for k, v in shapes.items()}
