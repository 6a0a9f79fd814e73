"""Trace generation on a torch device (luminair_tpu_torch/graph/device_trace.py
and the trace kernels' plain twins), on the CPU, against the reference
package's host interpreter: every PIE column, n_rows, op counter, retrieved
output and settings byte must be equal (tolerance 0: the values are
integers), and a proof from the device-path PIE must equal the reference's
host proof byte for byte."""

from dataclasses import replace

import numpy as np
import pytest
import torch

from luminair_tpu import fixed as ref_fixed
from luminair_tpu import prelude as R
from luminair_tpu import serde as ref_serde
from luminair_tpu.air.preprocessed import LookupLayout as RefLayout
from luminair_tpu.air.preprocessed import Range as RefRange
from luminair_tpu.graph.view import View as RefView
from luminair_tpu.parallel import accel
from luminair_tpu.verifier import verify as ref_verify
from luminair_tpu_torch import fields as f
from luminair_tpu_torch import fixed, kernels, serde
from luminair_tpu_torch import prelude as T
from luminair_tpu_torch.air.components import COMPONENTS_BY_NAME
from luminair_tpu_torch.air.preprocessed import LookupLayout, Range
from luminair_tpu_torch.errors import LuminairError, ProverError
from luminair_tpu_torch.graph import trace as port_trace
from luminair_tpu_torch.graph.view import View
from luminair_tpu_torch.models import black_scholes as bs
from luminair_tpu_torch.models import op_graphs
from tests import test_device_trace as ref_graphs
from tests.float_edges import EDGE_CASES, edge_floats
from tests.test_torch_pinn import XS, _reference_graph, _small_weights

CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """These small tensors prove faster on one CPU thread, and the suite's
    workers do not then compete for the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _bench(cx, d):
    rng = np.random.default_rng(0)
    a = cx.tensor((8, 8)).set(rng.normal(size=(8, 8)))
    b = cx.tensor((8, 8)).set(rng.normal(size=(8, 8)))
    (a * b + a).retrieve()


def _edge_mul_add(cx, d):
    """a * b + a on inputs at the edges of the fixed encoding: ties, signed
    zeros and subnormals, NaNs and infinities, the +-2^62 clip, float32
    values (tests/float_edges.py)."""
    x = edge_floats()
    n = len(x)
    a = cx.tensor((n,)).set(x)
    b = cx.tensor((n,)).set(np.roll(x[::-1], 5))
    (a * b + a).retrieve()


_BUILDERS = {"bench_n8": _bench, "edge_mul_add": _edge_mul_add}


def _ref_case(name):
    if name == "pinn":
        return _reference_graph(_small_weights())
    cx = R.Graph()
    _BUILDERS.get(name, getattr(ref_graphs, "build_" + name, None))(cx, ref_graphs.DATA)
    cx.compile()
    return cx


def _port_case(name):
    cx = T.Graph()
    if name == "pinn":
        x, _ = bs.build(cx, _small_weights(), batch=XS.shape[0])
        x.set(XS)
    else:
        _BUILDERS.get(name, op_graphs.GRAPHS.get(name))(cx, op_graphs.DATA)
    cx.compile()
    return cx


CASES = list(op_graphs.GRAPHS) + ["bench_n8", "pinn", "edge_mul_add"]


@pytest.fixture(scope="module")
def traced():
    """{case: (ref graph, ref settings, ref pie, port graph, port settings,
    port pie)}: the reference on its host interpreter, the port on its
    device interpreter with CPU tensors."""
    out = {}
    for name in CASES:
        rcx = _ref_case(name)
        rs = R.gen_circuit_settings(rcx, device=False)
        rp = R.gen_trace(rcx, rs, device=False)
        pcx = _port_case(name)
        ps = T.gen_circuit_settings(pcx, device="cpu")
        pp = T.gen_trace(pcx, ps, device="cpu")
        out[name] = (rcx, rs, rp, pcx, ps, pp)
    return out


@pytest.mark.parametrize("name", CASES)
def test_device_trace_matches_reference_host(traced, name):
    rcx, rs, rp, pcx, ps, pp = traced[name]
    assert ps.to_dict() == rs.to_dict()
    assert serde.settings_to_flat_bytes(ps) == ref_serde.settings_to_flat_bytes(rs)
    assert list(pp.trace_tables) == list(rp.trace_tables)
    for tname, rt in rp.trace_tables.items():
        t = pp.trace_tables[tname]
        assert t.n_rows == rt.n_rows and t.log_size == rt.log_size, tname
        assert list(t.columns) == list(rt.columns), tname
        for col, v in t.columns.items():
            assert v.device == CPU and v.dtype == torch.int32
            assert np.array_equal(f.tensor_to_u32(v), np.asarray(rt.columns[col])), (tname, col)
    assert dict(pp.metadata.execution_resources.op_counter) == dict(rp.metadata.execution_resources.op_counter)
    assert pp.metadata.execution_resources.max_log_size == rp.metadata.execution_resources.max_log_size
    assert sorted(pcx.output_data) == sorted(rcx.output_data)
    for rid, v in rcx.output_data.items():
        assert np.array_equal(pcx.output_data[rid], v), rid


@pytest.mark.parametrize("name", CASES)
def test_device_padding_matches_host_padding(traced, name):
    """The device tables are stored padded; their padding rows must be the
    host's (pie._PADDING_ONES / _PADDING_OVERRIDES)."""
    pcx, ps, pp = traced[name][3:]
    host = port_trace.gen_trace_host(pcx, ps)
    for tname, t in pp.trace_tables.items():
        names = COMPONENTS_BY_NAME[tname].MAIN
        want = host.trace_tables[tname].padded_columns(names)
        got = t.padded_columns(names)
        for col in names:
            assert len(got[col]) == 1 << t.log_size
            assert np.array_equal(f.tensor_to_u32(got[col]), want[col]), (tname, col)


def test_all_ops_proof_matches_reference(traced):
    """A proof from the device-path PIE of all_ops equals the reference's
    host proof byte for byte, and the reference verifier accepts it."""
    _, rs, rp, _, ps, pp = traced["all_ops"]
    assert {"sin", "exp2", "log2", "less_than", "rem", "sqrt", "recip", "max_reduce",
            "range_check_lookup"} <= set(pp.trace_tables)
    cfg = dict(pow_bits=1, log_blowup_factor=1, log_last_layer_degree_bound=0, n_queries=6)

    def config(pkg):
        return pkg.PcsConfig(pow_bits=cfg["pow_bits"], fri=pkg.FriConfig(
            log_blowup_factor=cfg["log_blowup_factor"],
            log_last_layer_degree_bound=cfg["log_last_layer_degree_bound"], n_queries=cfg["n_queries"]))

    was = accel.enabled()
    accel.enable(False)
    try:
        ref_bytes = ref_serde.proof_to_flat_bytes(R.prove(rp, rs, config(R)))
    finally:
        accel.enable(was)
    proof = T.prove(pp, ps, config(T), device="cpu")
    assert serde.proof_to_flat_bytes(proof) == ref_bytes
    assert ref_verify(ref_serde.proof_from_payload(serde.proof_to_payload(proof)), rs)


# ---------------------------------------------------------------------------
# The plain twins' arithmetic against the reference's numpy.

_EXTREMES = np.array(
    [0, 1, -1, 2, -2, 4095, -4096, 2**31 - 1, -(2**31), 2**62, -(2**62), 2**63 - 1, -(2**63),
     3037000499, 3037000500, 2**40 + 3, -(2**40) - 7], dtype=np.int64)


def _operands():
    rng = np.random.default_rng(31)
    aa, bb = np.meshgrid(_EXTREMES, _EXTREMES)
    a = np.concatenate([aa.ravel(), rng.integers(-2**63, 2**63 - 1, 500, dtype=np.int64),
                        rng.integers(-2**20, 2**20, 500), rng.integers(-3, 3, 100)])
    b = np.concatenate([bb.ravel(), rng.integers(-2**63, 2**63 - 1, 500, dtype=np.int64),
                        rng.integers(-2**20, 2**20, 500), rng.integers(-3, 3, 100)])
    return a, b


@pytest.mark.parametrize("op", ["to_m31", "add", "mul", "square", "recip", "sqrt", "div_rem", "less_than"])
def test_fixed_twins_match_reference(op):
    a, b = _operands()
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    with np.errstate(all="ignore"):
        if op == "to_m31":
            want, got = (ref_fixed.to_m31(a).astype(np.int64),), (fixed.t_to_m31(ta),)
        elif op == "add":
            want, got = (ref_fixed.add(a, b),), (fixed.t_add(ta, tb),)
        elif op in ("square", "recip", "sqrt"):
            want, got = getattr(ref_fixed, op)(a), getattr(fixed, "t_" + op)(ta)
        else:
            want, got = getattr(ref_fixed, op)(a, b), getattr(fixed, "t_" + op)(ta, tb)
    for w, g in zip(want, got):
        assert np.array_equal(np.asarray(w, dtype=np.int64), g.numpy())


@pytest.mark.parametrize("case", list(EDGE_CASES))
def test_from_float_twin_matches_host(host_rows, case):
    """The encode item's plain twin (fixed.t_from_float), its kernel's rows
    (trace.cuh through g++) and the host's fixed.from_float agree bit for
    bit at the edges of the encoding, with the reference package's."""
    x = EDGE_CASES[case]
    want = fixed.from_float(x)
    assert np.array_equal(want, ref_fixed.from_float(x))
    assert np.array_equal(fixed.t_from_float(torch.from_numpy(x)).numpy(), want)
    bits = torch.from_numpy(x.view(np.int64).copy())
    step = kernels.TraceStep("encode", [(bits, View.contiguous((len(x),)))], len(x),
                             out=torch.zeros(len(x), dtype=torch.int64))
    host_rows["trace_encode"](step)
    assert np.array_equal(step.out.numpy(), want)
    if case == "clip":
        assert set(np.abs(want[np.abs(x) >= 2.0**50])) == {1 << 62} and (np.abs(want) < 1 << 62).any()


def test_edge_inputs_trace_like_port_host():
    """The edge graph's device-path settings and PIE (every padded column)
    and outputs equal the port's host interpreter's (graph/trace.py), bit
    for bit."""
    cx = _port_case("edge_mul_add")
    settings = T.gen_circuit_settings(cx, device="cpu")
    pie = T.gen_trace(cx, settings, device="cpu")
    hcx = _port_case("edge_mul_add")
    hs = port_trace.gen_circuit_settings_host(hcx)
    host = port_trace.gen_trace_host(hcx, hs)
    assert serde.settings_to_flat_bytes(settings) == serde.settings_to_flat_bytes(hs)
    assert list(pie.trace_tables) == list(host.trace_tables)
    for tname, t in pie.trace_tables.items():
        names = COMPONENTS_BY_NAME[tname].MAIN
        want = host.trace_tables[tname].padded_columns(names)
        for col, v in t.padded_columns(names).items():
            assert np.array_equal(f.tensor_to_u32(v), want[col]), (tname, col)
    for rid, v in hcx.output_data.items():
        assert np.array_equal(cx.output_data[rid], v), rid


def test_device_path_encodes_no_input_on_the_host(monkeypatch):
    """With no LUT, the device path calls fixed.from_float on nothing longer
    than one value (the constants): the inputs are encoded by the settings
    pass's encode items, `encoded_inputs` of them in its `launches` span,
    and the trace pass takes them all from the graph's resident encoding
    (`resident_inputs` in its `upload` span) and encodes none.  The host
    interpreter, under the same watch, encodes whole inputs."""
    from luminair_tpu_torch import tracing

    lengths = []
    real = fixed.from_float

    def watched(x):
        lengths.append(np.size(x))
        return real(x)

    monkeypatch.setattr(fixed, "from_float", watched)
    for name in ("edge_mul_add", "slices", "broadcast"):
        cx = _port_case(name)
        assert not any(n.op in ("sin", "exp2", "log2") for n in cx.nodes)
        T.gen_trace(cx, T.gen_circuit_settings(cx, device="cpu"), device="cpu")
        n_inputs = sum(len(v) for v in cx.input_data.values())
        spans = tracing.requests()[-1].spans
        for kind, encoded in (("settings", n_inputs), ("trace", 0)):
            (launches,) = [sp for sp in spans if sp.path == kind + "/launches"]
            (upload,) = [sp for sp in spans if sp.path == kind + "/upload"]
            assert launches.counts.get("encoded_inputs") == encoded, (name, kind)
            assert upload.counts.get(tracing.RESIDENT_INPUTS) == n_inputs - encoded, (name, kind)
    assert lengths and max(lengths) <= 1, lengths
    port_trace.gen_trace_host(cx, port_trace.gen_circuit_settings_host(cx))
    assert max(lengths) > 1


@pytest.mark.parametrize("name", CASES)
def test_view_gather_matches_reference(traced, name):
    """Every edge's view of the graph, read from a random int64 buffer by
    the torch gather and by the reference's numpy gather."""
    rcx, pcx = traced[name][0], traced[name][3]
    rng = np.random.default_rng(5)
    n_edges = 0
    for rnode, pnode in zip(rcx.nodes, pcx.nodes):
        for (_, rv), (_, pv) in zip(rnode.srcs, pnode.srcs):
            buf = rng.integers(-2**62, 2**62, max(pv.buffer_len, 1))
            ref = RefView(rv.sizes, rv.strides, rv.base, rv.valid, rv.buffer_len)
            assert np.array_equal(pv.gather(torch.from_numpy(buf)).numpy(), ref.gather(buf))
            n_edges += 1
    assert n_edges > 0


def test_view_rank_limit_raises():
    v = View.contiguous((1,) * (kernels.VIEW_MAX_DIMS + 1))
    with pytest.raises(LuminairError):
        v.packed()
    # Reversed strides: no two dimensions merge, so all eight reach the kernel.
    order = tuple(range(kernels.VIEW_MAX_DIMS))[::-1]
    assert View.contiguous((2,) * kernels.VIEW_MAX_DIMS).permute(order).packed()[0] == kernels.VIEW_MAX_DIMS


def test_find_index_matches_reference():
    rng = np.random.default_rng(9)
    los = np.sort(rng.choice(np.arange(-10**6, 10**6, 1000), 12, replace=False))
    ranges = [(int(lo), int(lo + rng.integers(0, 900))) for lo in los]
    ref = RefLayout([RefRange(lo, hi) for lo, hi in ranges])
    port = LookupLayout([Range(lo, hi) for lo, hi in ranges])
    targets = np.concatenate([rng.integers(-2 * 10**6, 2 * 10**6, 5000), los, los - 1,
                              [hi for _, hi in ranges], [hi + 1 for _, hi in ranges]]).astype(np.int64)
    want = ref.find_index(targets)
    assert (want < 0).any() and (want >= 0).any()
    assert np.array_equal(port.find_index(torch.from_numpy(targets)).numpy(), want)
    assert np.array_equal(port.find_index(targets), want)


def test_lut_minmax_twin():
    """T4 on CPU tensors: the source's min and max, then the gathered input,
    in the head of the staging region."""
    buf = np.concatenate([_EXTREMES, np.random.default_rng(2).integers(-2**40, 2**40, 1000)])
    gathered = torch.from_numpy(np.random.default_rng(3).integers(-2**40, 2**40, 77))
    staging = torch.zeros(kernels.lut_boundary_words(len(buf), len(gathered)), dtype=torch.int64)
    got = kernels.lut_boundary(torch.from_numpy(buf), gathered, staging)
    assert got.tolist() == [buf.min(), buf.max()] + gathered.tolist()


# ---------------------------------------------------------------------------
# Errors and devices.


def test_lut_out_of_range_raises():
    """Settings whose sin table is too narrow: the trace raises, as the
    reference's host and device interpreters do."""
    cx = _port_case("all_ops")
    settings = T.gen_circuit_settings(cx, device="cpu")
    settings.lookups.sin.ranges[-1].hi -= 2000
    with pytest.raises(LuminairError, match="sin input outside LUT range"):
        T.gen_trace(cx, settings, device="cpu")


def test_max_reduce_range_raises_like_host():
    """Values beyond the provable range: a max_reduce step difference of
    2^30 or more raises in the settings pre-pass, on the host and on the
    device interpreter alike."""
    def graph():
        cx = T.Graph()
        cx.tensor((2, 3)).set([[0.0, 3e5, -3e5], [1.0, 2.0, 3.0]]).max_reduce(1).retrieve()
        cx.compile()
        return cx

    with pytest.raises(LuminairError, match="max_reduce"):
        port_trace.gen_circuit_settings_host(graph())
    with pytest.raises(LuminairError, match="max_reduce"):
        T.gen_circuit_settings(graph(), device="cpu")


def test_unknown_op_raises():
    cx = _port_case("broadcast")
    next(n for n in cx.nodes if n.op == "square").op = "cube"
    with pytest.raises(LuminairError, match="cube"):
        T.gen_circuit_settings(cx, device="cpu")


def test_trace_entry_points_default_to_cuda(monkeypatch):
    cx = _port_case("bench_n8")
    settings = T.gen_circuit_settings(cx, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ProverError, match="no CUDA device"):
        T.gen_circuit_settings(cx)
    with pytest.raises(ProverError, match="no CUDA device"):
        T.gen_trace(cx, settings)


def test_prove_rejects_trace_on_another_device(traced):
    """A PIE born on one device and a prover on another: prove() raises
    rather than copying the trace."""
    _, _, _, _, ps, pp = traced["bench_n8"]
    moved = {}
    for name, t in pp.trace_tables.items():
        padded = {k: v.to("meta") for k, v in t.padded.items()}
        moved[name] = type(t)(name, {k: v[: t.n_rows] for k, v in padded.items()}, padded=padded)
    with pytest.raises(ProverError, match="meta"):
        T.prove(type(pp)(moved, pp.metadata), ps, device="cpu")


# ---------------------------------------------------------------------------
# The kernels' own per-row C++ (csrc/trace.cuh), built for the host with the
# CUDA qualifiers defined away and one loop in place of the grid, against
# the plain twins.

_SHIM = r"""
#include <algorithm>
#include <random>
#include <utility>
#include <vector>
#define __host__
#define __device__
#define __forceinline__ inline
static inline unsigned atomicAdd(unsigned* p, unsigned v) { unsigned o = *p; *p += v; return o; }
#include "trace.cuh"
// A CTA of T threads whose phases run thread after thread.
struct HostBlock {
  int T;
  int threads() const { return T; }
  void sync() const {}
  template <class F>
  void each(F f) const { for (int t = 0; t < T; t++) f(t); }
};
extern "C" long long h_args_size() { return sizeof(lum::TraceArgs); }
extern "C" long long h_seg_args_size() { return sizeof(lum::SegArgs); }
extern "C" void h_binary(const lum::TraceArgs* a) { for (long long i = 0; i < a->n; i++) lum::binary_row(*a, i); }
extern "C" void h_unary(const lum::TraceArgs* a) { for (long long i = 0; i < a->n; i++) lum::unary_row(*a, i); }
extern "C" void h_rows(const lum::TraceArgs* a) { for (long long i = 0; i < a->n; i++) lum::segment_row(*a, i); }
extern "C" void h_reduce_ctas(const lum::TraceArgs* a, int T) {
  std::vector<long long> raw(T), scan(2 * T);
  std::vector<int> pos(T);
  const long long per = lum::reduce_outputs_per_cta(a->dsize, T);
  for (long long c = 0; c < (a->n + per - 1) / per; c++) lum::reduce_cta(HostBlock{T}, *a, c, raw.data(), scan.data(), pos.data());
}
extern "C" void h_reduce(const lum::TraceArgs* a) { h_reduce_ctas(a, 256); }  // the card's CTA
// The segment interpreter on a host grid: the phases between two barriers
// form a group, and a group's tiles (phase, tile) run one after another in
// a seeded shuffled order, as CTAs of a grid may take them, each through
// every item of its chain; a barrier ends the group.
extern "C" void h_segment(const lum::SegArgs* s, unsigned seed) {
  const auto* nodes = (const lum::TraceArgs*)s->nodes;
  const auto* chains = (const lum::SegChain*)s->chains;
  const auto* phases = (const lum::SegPhase*)s->phases;
  std::mt19937 rng(seed);
  for (int p = s->p0; p < s->p1;) {
    int q = p + 1;
    while (q < s->p1 && !lum::barrier_before(q, s->p0)) q++;
    std::vector<std::pair<int, long long>> work;
    for (int k = p; k < q; k++)
      for (long long t = 0; t < phases[k].tiles; t++) work.emplace_back(k, t);
    std::shuffle(work.begin(), work.end(), rng);
    for (const auto& w : work) {
      const lum::SegChain& c = chains[lum::tile_chain(chains, phases[w.first], w.second)];
      for (int j = 0; j < c.count; j++)
        lum::tile_rows(HostBlock{lum::SEG_THREADS}, nodes[c.first + j], w.second - c.tile0, c.shift);
    }
    p = q;
  }
}
extern "C" void h_gather(const lum::ViewDesc* v, const long long* buf, long long n, long long* out) {
  for (long long i = 0; i < n; i++) out[i] = lum::gather(*v, buf, (uint32_t)i);
}
extern "C" unsigned h_fast_div(unsigned n, unsigned magic, unsigned shift) { return lum::fast_div(n, magic, shift); }
"""


def _build_rows(d, header=None):
    """{wrapper name: a function running one TraceStep through trace.cuh
    (or through `header` in its place)}, built with g++ in `d`."""
    import ctypes
    import shutil
    import subprocess
    from pathlib import Path

    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no C++ compiler for the host build of csrc/trace.cuh")
    (d / "shim.cpp").write_text(_SHIM)
    inc = Path(kernels.__file__).resolve().parent / "csrc"
    if header is not None:
        (d / "trace.cuh").write_text(header)
        inc = d
    subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-I", str(inc), "-o", str(d / "rows.so"),
                    str(d / "shim.cpp")], check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(d / "rows.so"))
    lib.h_args_size.restype = lib.h_seg_args_size.restype = ctypes.c_longlong
    assert lib.h_args_size() == ctypes.sizeof(kernels.TraceArgs)
    assert lib.h_seg_args_size() == ctypes.sizeof(kernels.SegArgs)

    def runner(fn):
        fn.argtypes = [ctypes.c_void_p]

        def run(step):
            args = kernels._trace_args(step, CPU)
            fn(ctypes.addressof(args))

        return run

    lib.h_reduce_ctas.argtypes = [ctypes.c_void_p, ctypes.c_int]

    def reduce_ctas(step, threads):
        args = kernels._trace_args(step, CPU)
        lib.h_reduce_ctas(ctypes.addressof(args), threads)

    lib.h_segment.argtypes = [ctypes.c_void_p, ctypes.c_uint]

    def segment(seg, seed=0):
        args = seg.args()
        lib.h_segment(ctypes.addressof(args), seed)

    lib.h_gather.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]

    def gather(view, buf):
        desc = kernels.ViewDesc.from_buffer_copy(kernels._view_bytes(view, len(buf)))
        out = torch.zeros(view.n_elements, dtype=torch.int64)
        lib.h_gather(ctypes.addressof(desc), buf.data_ptr(), len(out), out.data_ptr())
        return out

    lib.h_fast_div.argtypes = [ctypes.c_uint] * 3
    lib.h_fast_div.restype = ctypes.c_uint
    rows = runner(lib.h_rows)

    def segment_rows(seg):
        """A segment's items in table order, each row by trace.cuh's
        segment_row (no tiles, no phases)."""
        for step in seg.steps():
            rows(step)

    return {"trace_binary": runner(lib.h_binary), "trace_unary": runner(lib.h_unary), "trace_pad": rows,
            "trace_encode": rows,
            "trace_reduce": runner(lib.h_reduce), "reduce_ctas": reduce_ctas, "segment": segment,
            "segment_rows": segment_rows, "gather": gather, "fast_div": lib.h_fast_div}


@pytest.fixture(scope="module")
def host_rows(tmp_path_factory):
    """{wrapper name: a function running one TraceStep through trace.cuh}."""
    return _build_rows(tmp_path_factory.mktemp("trace_rows"))


@pytest.mark.parametrize("name", CASES)
def test_kernel_rows_trace_like_twins(traced, host_rows, name, monkeypatch):
    """The whole device interpreter with trace.cuh's rows in place of the
    twins gives the twins' PIE, settings and outputs."""
    _, _, _, pcx, ps, pp = traced[name]
    monkeypatch.setattr(kernels, "trace_segment", host_rows["segment_rows"])
    monkeypatch.setattr(kernels, "trace_reduce", host_rows["trace_reduce"])
    assert not _trace_mismatches(name, pcx, ps, pp)


def _trace_mismatches(name, pcx, ps, pp) -> list:
    """Where the case's settings, PIE (every padded column) and outputs,
    traced through whatever kernels.trace_segment / trace_reduce now are,
    differ from the twins' (empty when they are equal)."""
    cx = _port_case(name)
    settings = T.gen_circuit_settings(cx, device="cpu")
    pie = T.gen_trace(cx, settings, device="cpu")
    if settings.to_dict() != ps.to_dict() or list(pie.trace_tables) != list(pp.trace_tables):
        return ["settings or tables"]
    bad = [(tname, col) for tname, t in pp.trace_tables.items() for col, v in t.padded.items()
           if not torch.equal(pie.trace_tables[tname].padded[col], v)]
    return bad + [rid for rid, v in pcx.output_data.items() if not np.array_equal(cx.output_data[rid], v)]


@pytest.mark.parametrize("name", CASES)
def test_segment_body_traces_like_twins(traced, host_rows, name, monkeypatch):
    """The whole device interpreter with trace.cuh's segment interpreter on
    a host grid (each segment's phases in order, the tiles of a phase in a
    seeded shuffled order) gives the twins' PIE, settings and outputs --
    the reference's host interpreter's, tolerance 0."""
    _, _, _, pcx, ps, pp = traced[name]
    seeds = iter(range(1000))
    monkeypatch.setattr(kernels, "trace_segment", lambda seg: host_rows["segment"](seg, next(seeds)))
    monkeypatch.setattr(kernels, "trace_reduce", host_rows["trace_reduce"])
    assert not _trace_mismatches(name, pcx, ps, pp)
    assert next(seeds) > 0


def _phased_graph():
    """A graph whose segments have several phases: rows that read other
    rows' outputs (transposes, a broadcast of one column) with no
    reduction between them."""
    cx = T.Graph()
    rng = np.random.default_rng(3)
    a = cx.tensor((16, 16)).set(rng.uniform(-1.0, 1.0, (16, 16)))
    b = a * a
    c = b.permute((1, 0)) * b + b.slice_dim(1, 0, 1).expand(1, 16)
    (c.permute((1, 0)).contiguous() + c).retrieve()
    cx.compile()
    return cx


def _recorded_segments(graphs):
    """Every segment of the settings pass and trace of each compiled graph,
    run by the twin and kept with its pass's buffers."""
    segs = []

    def record(seg):
        segs.append(seg)
        kernels.trace_segment_plain(seg)

    was = kernels.trace_segment
    kernels.trace_segment = record
    try:
        for cx in graphs:
            T.gen_trace(cx, T.gen_circuit_settings(cx, device="cpu"), device="cpu")
    finally:
        kernels.trace_segment = was
    return segs


def _merged(seg):
    """The segment with its first two phases merged into one (a dependent
    pair of chains then shares a phase), or None when it has one phase."""
    t = seg.table
    if seg.p1 - seg.p0 < 2:
        return None
    (f0, c0), (_, c1) = t.phases[seg.p0 : seg.p0 + 2]
    phases = t.phases[: seg.p0] + [(f0, c0 + c1)] + t.phases[seg.p0 + 2 :]
    table = kernels.NodeTable(t.buffers, t.items, t.chains, phases, t.segments, t.at)
    table.upload()
    return kernels.TraceSegment(table, seg.p0, seg.p1 - 1)


# Mutations the segment interpreter must catch: a barrier dropped between
# two phases of a segment (trace.cuh), two dependent phases merged into one
# (the node table).  Each segment of several phases of a graph's passes is
# run from fresh outputs through the mutated interpreter on the host grid
# (three seeds) and through the twin.
@pytest.mark.parametrize("mutation", ["barrier", "phases"])
def test_mutated_segment_fails(host_rows, tmp_path, mutation):
    from pathlib import Path

    header = None
    if mutation == "barrier":
        old = "bool barrier_before(int p, int p0) { return p > p0; }"
        header = (Path(kernels.__file__).resolve().parent / "csrc" / "trace.cuh").read_text()
        assert header.count(old) == 1
        header = header.replace(old, "bool barrier_before(int p, int p0) { return false; }")
    rows = _build_rows(tmp_path, header)
    multi = bad = 0
    for seg in _recorded_segments([_phased_graph(), _port_case("all_ops")]):
        if seg.p1 - seg.p0 < 2:
            continue
        multi += 1
        want, control = seg.fresh(), seg.fresh()
        kernels.trace_segment_plain(want)
        host_rows["segment"](control, 0)  # the interpreter as it is
        assert torch.equal(control.outputs(), want.outputs())
        for seed in range(3):
            got = seg.fresh() if mutation == "barrier" else _merged(seg.fresh())
            rows["segment"](got, seed)
            bad += not torch.equal(got.outputs(), want.outputs())
    assert multi and bad, (multi, bad)


TRACE_SEED = 400


def _random_step(op, rng):
    from luminair_tpu_torch.graph.device_trace import TABLE_COLUMNS

    a, b = (torch.from_numpy(x) for x in _operands())
    if op == "max_reduce":  # step differences inside and outside [0, 2^30)
        a = torch.from_numpy(rng.integers(-2**31, 2**31, len(a)))
    n = len(a) - len(a) % 60
    a, b = a[:n].contiguous(), b[:n].contiguous()
    table = {"inputs": "inputs", "lut": "sin", "pad": "mul"}.get(op, op)
    view = View.contiguous((n,))
    kw = dict(out_mult=5, mult=torch.zeros(256, dtype=torch.int32), flag=torch.zeros(1, dtype=torch.int32))
    if op in ("add", "mul", "rem", "less_than"):
        srcs, rows = [(a, view), (b, View.contiguous((n,)))], n
    elif op in ("sum_reduce", "max_reduce"):
        view = View.contiguous((n // 60, 6, 10)).permute((2, 0, 1))  # reduce the middle axis of a permuted view
        srcs, rows = [(a, view)], view.shape[0] * view.shape[2]
        kw.update(dsize=view.shape[1], back=view.shape[2])
    elif op == "contiguous":
        view = View.contiguous((n // 3, 3)).permute((1, 0)).slice(1, 1, n // 6)
        srcs, rows = [(a, view)], max(n, view.n_elements)
        kw["in_mult"] = 77
    elif op == "lut":
        layout = LookupLayout([Range(-5000, -100), Range(0, 4000), Range(10**6, 10**6 + 50)])
        x = torch.from_numpy(rng.integers(-6000, 5000, n))
        srcs, rows = [(x, view)], n
        los, his, starts = (torch.from_numpy(v) for v in layout.packed())
        kw.update(lut=(los, his, starts, torch.from_numpy(rng.integers(-2**40, 2**40, layout.value_count()))),
                  mult=torch.zeros(1 << layout.log_size, dtype=torch.int32))
    elif op == "pad":  # a table's padding rows: every column gets out_mult
        srcs, rows = [], n
        kw = dict(out_mult=5)
    elif op == "encode":  # an input's float64 bits: the encoding's edges, random words
        x = torch.from_numpy(np.concatenate([edge_floats().view(np.int64), a.numpy()]))
        return kernels.TraceStep(op, [(x, View.contiguous((len(x),)))], len(x),
                                 out=torch.zeros(len(x), dtype=torch.int64))
    else:
        srcs, rows = [(a, view)], n
    n_rows = rows * kw.get("dsize", 1)
    n_out = view.n_elements if op == "contiguous" else rows
    cols = {c: torch.zeros(n_rows, dtype=torch.int32) for c in TABLE_COLUMNS[table]}
    out = None if op == "pad" else torch.zeros(n_out, dtype=torch.int64)
    return kernels.TraceStep(op, srcs, rows, out=out, cols=cols, ids=(7, 3, 4), **kw)


@pytest.mark.parametrize("op", kernels.TRACE_OPS)
def test_kernel_rows_match_twins_on_extremes(host_rows, op):
    """One step of each op on int64 extremes, random values and small
    values (divisions by 0 and -1, wrapping products, negative remainders,
    LUT misses, max_reduce steps beyond 2^30), through trace.cuh's rows and
    through the twin."""
    step = _random_step(op, np.random.default_rng(TRACE_SEED + kernels.TRACE_OPS.index(op)))
    wrapper = ("trace_binary" if op in ("add", "mul", "rem", "less_than")
               else "trace_reduce" if op.endswith("_reduce") else "trace_" + op if op in ("pad", "encode")
               else "trace_unary")
    k, p = step.fresh(), step.fresh()
    host_rows[wrapper](k)
    getattr(kernels, wrapper + "_plain")(p)
    assert torch.equal(k.outputs(), p.outputs())
    if op in ("lut", "max_reduce"):
        assert int(p.flag) == 1  # the inputs reach outside the ranges



def _scan_step(op, dsize, back, rng):
    """A reduction of the middle axis of a permuted (2, dsize, back) view
    (the input of row (o, k) a stride of `back` from its neighbour), on
    values whose max steps land inside and outside [0, 2^30)."""
    from luminair_tpu_torch.graph.device_trace import TABLE_COLUMNS

    n = 2 * dsize * back
    hi = 2**31 if op == "max_reduce" else 2**62
    buf = torch.from_numpy(rng.integers(-hi, hi, n))
    view = View.contiguous((2, back, dsize)).permute((0, 2, 1))
    rows = 2 * back
    cols = {c: torch.zeros(rows * dsize, dtype=torch.int32) for c in TABLE_COLUMNS[op]}
    return kernels.TraceStep(op, [(buf, view)], rows, out=torch.zeros(rows, dtype=torch.int64), cols=cols,
                             ids=(9, 2, 0), out_mult=3, dsize=dsize, back=back,
                             mult=torch.zeros(256, dtype=torch.int32), flag=torch.zeros(1, dtype=torch.int32))


# Segments shorter than a CTA, a CTA's width, and longer (walked in chunks);
# CTAs of 7 threads (segments of 2 and 3 leave threads idle, longer ones
# split) and of the card's 256.
@pytest.mark.parametrize("back", [1, 5, 64])
@pytest.mark.parametrize("dsize", [1, 2, 3, 64, 300, 1025])
@pytest.mark.parametrize("op", ["sum_reduce", "max_reduce"])
def test_reduce_scan_matches_twin(host_rows, op, dsize, back):
    """T3's segmented scan through trace.cuh against the twin's cumulative
    sum / max: every column, the output, the histogram and the flag; and
    the settings pre-pass (no columns) writes the same output."""
    step = _scan_step(op, dsize, back, np.random.default_rng(dsize * 100 + back))
    p = step.fresh()
    kernels.trace_reduce_plain(p)
    for threads in (7, 256):
        k = step.fresh()
        host_rows["reduce_ctas"](k, threads)
        assert torch.equal(k.outputs(), p.outputs()), threads
        values_only = replace(step.fresh(), cols={}, mult=None)
        host_rows["reduce_ctas"](values_only, threads)
        assert torch.equal(values_only.out, p.out)
    if op == "max_reduce" and dsize > 1:
        assert int(p.flag) == 1 and int(p.mult.sum()) == 4 * 2 * back * dsize


# Mutations the scan must catch: the carry between chunks dropped, rows of
# the previous segment combined, the element before a row taken as its
# running value.
@pytest.mark.parametrize("mutation", [
    ("if (!whole && c0 > 0) {", "if (false) {"),
    ("if (t >= off && pos[t] >= off) {", "if (t >= off) {"),
    ("(t > 0 ? src[t - 1] : carry)", "(t > 0 ? raw[t - 1] : carry)"),
])
def test_mutated_scan_fails(tmp_path, mutation):
    from pathlib import Path

    old, new = mutation
    header = (Path(kernels.__file__).resolve().parent / "csrc" / "trace.cuh").read_text()
    assert header.count(old) == 1
    rows = _build_rows(tmp_path, header.replace(old, new))
    bad = 0
    for dsize, back in ((3, 5), (300, 1)):
        step = _scan_step("sum_reduce", dsize, back, np.random.default_rng(dsize))
        k, p = step.fresh(), step.fresh()
        rows["reduce_ctas"](k, 7)
        kernels.trace_reduce_plain(p)
        bad += not torch.equal(k.outputs(), p.outputs())
    assert bad


# ---------------------------------------------------------------------------
# Packed 32-bit views (View.packed, trace.cuh gather) against View.gather.


def _packed_gather_torch(view, buf):
    """The packed view resolved as trace.cuh's gather does, in torch: the
    fast divmod of each inner size, the clamp and the box."""
    ndim, sizes, strides, los, his, base, magic, shift = view.packed()
    rest = torch.arange(view.n_elements, dtype=torch.int64)
    phys = torch.full_like(rest, base)
    ok = torch.ones_like(rest, dtype=torch.bool)
    for d in range(ndim - 1, -1, -1):
        c = rest
        if d > 0:
            q = (rest * magic[d]) >> shift[d]
            c, rest = rest - q * sizes[d], q
        phys = phys + c * strides[d]
        ok &= (c >= los[d]) & (c < his[d])
    return torch.where(ok, buf[phys.clamp(0, len(buf) - 1)], 0)


def _random_view(rng):
    """A contiguous view of 1-4 dims moved by 1-5 random permutes, slices,
    broadcasts, inserted dims and pads."""
    shape = tuple(int(x) for x in rng.integers(1, 7, rng.integers(1, 5)))
    v = View.contiguous(shape)
    for _ in range(rng.integers(1, 6)):
        kind = rng.integers(0, 5)
        d = int(rng.integers(0, len(v.sizes)))
        if kind == 0:
            v = v.permute(tuple(int(x) for x in rng.permutation(len(v.sizes))))
        elif kind == 1 and v.sizes[d] > 1:
            start = int(rng.integers(0, v.sizes[d]))
            v = v.slice(d, start, int(rng.integers(start, v.sizes[d] + 1)))
        elif kind == 2 and v.sizes[d] == 1:
            v = v.broadcast(d, int(rng.integers(2, 5)))
        elif kind == 3 and len(v.sizes) < kernels.VIEW_MAX_DIMS:
            v = v.insert(d, int(rng.integers(1, 4)))
        else:
            v = v.pad(d, int(rng.integers(0, 3)), int(rng.integers(0, 3)))
    return v


@pytest.mark.parametrize("seed", range(12))
def test_packed_view_matches_gather(host_rows, seed):
    """Random views: the packed form through trace.cuh's gather (g++) and
    through its torch transcription equal View.gather, tolerance 0."""
    rng = np.random.default_rng(1000 + seed)
    for _ in range(40):
        v = _random_view(rng)
        buf = torch.from_numpy(rng.integers(-2**62, 2**62, max(v.buffer_len, 1)))
        want = v.gather(buf)
        assert torch.equal(_packed_gather_torch(v, buf), want), v
        assert torch.equal(host_rows["gather"](v, buf), want), v


def _odd_views():
    """Edge views: sizes of 1, powers of two and odd sizes, merged and kept
    dims, a zero-size dim, negative strides, boxes outside the sizes."""
    c = View.contiguous
    return [
        c((1,)), c(()), c((1, 1, 1)), c((2, 4, 8)), c((3, 5, 7)).permute((2, 0, 1)),
        c((2,) * 8).permute(tuple(range(8))[::-1]), c((4, 0, 3)), c((6, 6)).pad(0, 3, 2).slice(0, 4, 8),
        c((5, 3)).slice(1, 1, 2).broadcast(1, 9), c((1, 4)).broadcast(0, 1 << 10).permute((1, 0)),
        View((3, 4), (-4, 1), 8, ((0, 3), (0, 4)), 12), View((4, 3), (1, -4), 9, ((1, 3), (0, 3)), 12),
        View((2, 3), (3, 1), 0, ((-2, 5), (2, 1)), 6), View((1 << 16, 2), (2, 1), 0, ((0, 1 << 16), (0, 2)), 1 << 17),
    ]


@pytest.mark.parametrize("k", range(14))
def test_packed_edge_views_match_gather(host_rows, k):
    v = _odd_views()[k]
    buf = torch.from_numpy(np.random.default_rng(k).integers(-2**62, 2**62, max(v.buffer_len, 1)))
    want = v.gather(buf)
    assert torch.equal(_packed_gather_torch(v, buf), want)
    assert torch.equal(host_rows["gather"](v, buf), want)


@pytest.mark.parametrize("size", [1, 2, 3, 5, 7, 1 << 10, (1 << 10) + 1, 12345, (1 << 30) - 1, 1 << 30,
                                  (1 << 30) + 1, (1 << 31) - 1])
def test_fast_divmod_edges(host_rows, size):
    """n // size == (n * magic) >> shift for the dividends at the edges of
    [0, 2^31) and around multiples of the size, in Python and in
    trace.cuh's fast_div (g++); magic fits in 32 bits."""
    magic, shift = kernels.fast_divmod(size)
    assert 0 < magic < 1 << 32
    top = (1 << 31) - 1
    rng = np.random.default_rng(size)
    ns = {0, 1, size - 1, size, size + 1, top, top - 1, top - top % size, top - top % size - 1}
    ns |= {int(x) for x in rng.integers(0, 1 << 31, 200)}
    ns |= {m * size + e for m in (1, 2, top // size) for e in (-1, 0, 1)}
    for n in sorted(x for x in ns if 0 <= x <= top):
        assert (n * magic) >> shift == n // size, n
        assert host_rows["fast_div"](n, magic, shift) == n // size, n


def test_node_of_2_31_rows_raises():
    """A view or a node of 2^31 elements raises before anything is
    allocated: its idx column could not hold the row."""
    with pytest.raises(LuminairError, match="2\\^31"):
        View.contiguous((1 << 31,)).packed()
    assert View.contiguous(((1 << 31) - 1,)).packed()[0] == 1
    cx = T.Graph()
    a = cx.tensor((1 << 16, 1 << 15))
    (a * a).retrieve()
    cx.compile()
    with pytest.raises(LuminairError, match="2\\^31"):
        T.gen_circuit_settings(cx, device="cpu")


def test_segment_of_many_rows(host_rows):
    """A segment whose chains take tiles of several rows a thread: a table's
    padding (two columns of 600,000 rows, column after column) and a chain
    of an add and a mul of 1,100,000 rows, the mul reading the add at its
    own row; trace.cuh's interpreter on the host grid against the twin."""
    n, pad, rows0 = 1_100_000, 600_000, 24_288
    rng = np.random.default_rng(8)
    arena = torch.zeros(4 * n + kernels.NodeTable.n_words(3, 2, 1), dtype=torch.int64)
    arena[: 2 * n] = torch.from_numpy(rng.integers(-2**40, 2**40, 2 * n))
    size = 1 << 20
    storage = {"mul": (["lhs", "rhs"], torch.zeros((2, size), dtype=torch.int32))}
    view = View.contiguous((n,))
    items = [
        kernels.TraceItem("pad", pad, table="mul", row0=rows0, columns=("lhs", "rhs"), out_mult=7),
        kernels.TraceItem("add", n, ((0, n, view), (n, n, view)), out=(2 * n, n), ids=(5, 1, 2)),
        kernels.TraceItem("mul", n, ((2 * n, n, view), (0, n, view)), out=(3 * n, n), ids=(6, 5, 1)),
    ]
    table = kernels.NodeTable(kernels.TraceBuffers(arena, storage, flags=torch.zeros(4, dtype=torch.int32)), items,
                              [(0, 1), (1, 2)], [(0, 2)], [(0, 1)], 4 * n)
    assert min(table.shifts) > 0 and max(table.tiles) <= kernels.SEG_MAX_TILES
    table.upload()
    seg = table.segment(0)
    want, got = seg.fresh(), seg.fresh()
    kernels.trace_segment_plain(want)
    host_rows["segment"](got, 1)
    assert torch.equal(got.outputs(), want.outputs())
    assert int(want.table.buffers.storage["mul"][1][0, rows0 + pad - 1]) == 7
