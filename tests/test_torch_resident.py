"""The graph's inputs resident on the device (graph/device_trace.py): a pass
stages and encodes only the inputs `set` since the graph's last pass, takes
the rest from the graph's record, and gives the bytes a freshly built graph
gives for the same inputs."""

import gc
import weakref

import numpy as np
import pytest

from luminair_tpu_torch import prelude as T
from luminair_tpu_torch import serde, tracing
from luminair_tpu_torch.graph import device_trace

CONFIG = T.PcsConfig(fri=T.FriConfig(log_blowup_factor=1))
SIZES = {"a": (4, 8), "b": (8,), "c": (4, 8), "d": (8,)}  # d is never set: zeros


def _graph():
    """a * b + c and sum(exp2(a) * d) over rows: a LUT round trip and a
    reduction in the settings pass."""
    cx = T.Graph()
    t = {k: cx.tensor(s) for k, s in SIZES.items()}
    (t["a"] * t["b"].expand_to((4, 8)) + t["c"]).retrieve()
    (t["a"].exp2() * t["d"].expand_to((4, 8))).sum_reduce(1).retrieve()
    cx.compile()
    return cx, t


def _arrays(seed):
    rng = np.random.default_rng(seed)
    return {k: rng.uniform(-2.0, 2.0, size=s) for k, s in SIZES.items() if k != "d"}


class _Passes:
    """Each pass's staged input values and counters, by pass kind."""

    def __init__(self, monkeypatch):
        self.staged = []
        upload = device_trace._Layout.upload

        def watched(layout, table, words):
            self.staged.append(sum(n for _, n in layout.raw.values()))
            return upload(layout, table, words)

        monkeypatch.setattr(device_trace._Layout, "upload", watched)

    def request(self, cx):
        """One settings and trace pass: {kind: (staged, encoded, resident, repeat)}."""
        self.staged.clear()
        T.gen_trace(cx, T.gen_circuit_settings(cx, device="cpu"), device="cpu")
        spans = tracing.requests()[-1].spans
        out = {}
        for kind, staged in zip(("settings", "trace"), self.staged):
            (up,) = [s for s in spans if s.path == kind + "/upload"]
            (launches,) = [s for s in spans if s.path == kind + "/launches"]
            out[kind] = (staged, launches.counts[device_trace.ENCODED_INPUTS], up.counts[tracing.RESIDENT_INPUTS],
                         up.counts[tracing.H2D_REPEAT])
        return out


def _n(*names):
    return sum(int(np.prod(SIZES[k])) for k in names)


# the second request: which inputs it sets (`in place`: b's array changed
# in place and set again), and the values its settings pass stages
SECOND = {"nothing set": ((), 0), "a set": (("a",), _n("a")), "b changed in place": (("b in place",), _n("b")),
          "a and c set": (("a", "c"), _n("a", "c"))}


@pytest.mark.parametrize("case", sorted(SECOND))
def test_a_pass_stages_and_encodes_only_the_inputs_set_since(monkeypatch, case):
    passes = _Passes(monkeypatch)
    cx, t = _graph()
    arrays = _arrays(1)
    for k, a in arrays.items():
        t[k].set(a)
    everything = _n(*SIZES)
    first = passes.request(cx)
    assert first == {"settings": (everything, everything, 0, 0), "trace": (0, 0, everything, 0)}
    names, staged = SECOND[case]
    fresh = _arrays(2)
    for k in names:
        if k == "b in place":
            arrays["b"][...] = fresh["b"]
            t["b"].set(arrays["b"])
        else:
            t[k].set(fresh[k])
    second = passes.request(cx)
    assert second == {"settings": (staged, staged, everything - staged, 0), "trace": (0, 0, everything, 0)}


def test_an_array_changed_in_place_and_not_set_keeps_its_bound_encoding():
    cx, t = _graph()
    arrays = _arrays(3)
    for k, a in arrays.items():
        t[k].set(a)
    T.gen_trace(cx, T.gen_circuit_settings(cx, device="cpu"), device="cpu")
    before = {rid: v.copy() for rid, v in cx.output_data.items()}
    arrays["a"] += 1.0  # not set again: the data bound at `set` stays
    T.gen_trace(cx, T.gen_circuit_settings(cx, device="cpu"), device="cpu")
    assert all(np.array_equal(cx.output_data[rid], v) for rid, v in before.items())
    t["a"].set(arrays["a"])
    T.gen_trace(cx, T.gen_circuit_settings(cx, device="cpu"), device="cpu")
    assert any(not np.array_equal(cx.output_data[rid], v) for rid, v in before.items())


def test_a_record_for_another_device_is_not_used_and_the_repeat_counted(monkeypatch):
    """A record whose values lie elsewhere (here: moved to the meta device)
    is not this pass's: every input is staged again, and the ones not set
    since count in `h2d_repeat`."""
    passes = _Passes(monkeypatch)
    cx, t = _graph()
    for k, a in _arrays(4).items():
        t[k].set(a)
    passes.request(cx)
    cx.resident.values = cx.resident.values.to("meta")
    t["a"].set(_arrays(5)["a"])
    everything = _n(*SIZES)
    got = passes.request(cx)
    assert got == {"settings": (everything, everything, 0, 8 * (everything - _n("a"))),
                   "trace": (0, 0, everything, 0)}
    assert cx.resident.values.device.type == "cpu"


def _result(cx, settings, pie):
    proof = T.prove(pie, settings, CONFIG, device="cpu")
    columns = {(name, col): v.numpy().copy() for name, tb in pie.trace_tables.items() for col, v in tb.padded.items()}
    outputs = {rid: v.copy() for rid, v in cx.output_data.items()}
    return serde.settings_to_flat_bytes(settings), columns, outputs, serde.proof_to_flat_bytes(proof)


# requests after the first: the inputs each sets anew from its seed
RUNS = {"none, then a": [(), ("a",)], "b, then none": [("b",), ()], "a and c, then b in place": [("a", "c"), ("b",)]}


@pytest.mark.parametrize("run", sorted(RUNS))
def test_a_run_of_requests_gives_the_bytes_of_a_fresh_graph(run):
    cx, t = _graph()
    arrays = _arrays(6)
    for k, a in arrays.items():
        t[k].set(a)
    for i, names in enumerate([tuple(arrays)] + RUNS[run]):
        for k in names:
            if i:
                arrays[k][...] = _arrays(10 + i)[k]  # in place, then set again
            t[k].set(arrays[k])
        settings = T.gen_circuit_settings(cx, device="cpu")
        got = _result(cx, settings, T.gen_trace(cx, settings, device="cpu"))
        fx, ft = _graph()
        for k, a in arrays.items():
            ft[k].set(a.copy())
        fs = T.gen_circuit_settings(fx, device="cpu")
        want = _result(fx, fs, T.gen_trace(fx, fs, device="cpu"))
        assert got[0] == want[0], (run, i)
        assert got[1].keys() == want[1].keys()
        for key, v in want[1].items():
            assert np.array_equal(got[1][key], v), (run, i, key)
        assert got[2].keys() == want[2].keys()
        for rid, v in want[2].items():
            assert np.array_equal(got[2][rid], v), (run, i, rid)
        assert got[3] == want[3], (run, i)


def test_the_record_is_freed_with_the_graph():
    cx, t = _graph()
    for k, a in _arrays(7).items():
        t[k].set(a)
    T.gen_trace(cx, T.gen_circuit_settings(cx, device="cpu"), device="cpu")
    values = weakref.ref(cx.resident.values)
    graph = weakref.ref(cx)
    del cx, t
    gc.collect()
    assert graph() is None and values() is None
