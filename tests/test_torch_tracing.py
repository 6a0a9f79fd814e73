"""The port's spans and counters (luminair_tpu_torch/tracing.py): one tree of
spans a request, synchronised only for a listener, on the profiler's clock,
with the copies and launches counted under the span in flight."""

import copy
import logging
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from luminair_tpu_torch import fields as f
from luminair_tpu_torch import kernels
from luminair_tpu_torch import prelude as T
from luminair_tpu_torch import serde, tracing
from portbench.profile import SpanLog

CFG = T.PcsConfig(pow_bits=1, fri=T.FriConfig(log_blowup_factor=1, n_queries=2, folds_per_layer=1,
                                                 log_last_layer_degree_bound=0))
PROVE_PHASES = ("phase0_preprocessed", "phase1_main", "phase2_interaction", "phase3a_composition",
                "phase3b_oods_fri", "self_check")
LISTENERS = ("none", "enable", "logger")


def _graph():
    cx = T.Graph()
    rng = np.random.default_rng(3)
    a = cx.tensor((2, 2)).set(rng.uniform(0.2, 1.2, (2, 2)))
    (a.exp2() * a + a).retrieve()
    cx.compile()
    return cx


def _request(cx):
    settings = T.gen_circuit_settings(cx, device="cpu")
    pie = T.gen_trace(cx, settings, device="cpu")
    proof = T.prove(pie, settings, CFG, device="cpu")
    return settings, proof


@pytest.fixture(scope="module")
def runs():
    """One request a listener, every span's device synchronise counted by
    a fake that the passes take for the CPU's; the logger's records of the
    third; the latest passes' phases after each."""
    cx = _graph()
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        syncs = []
        mp.setattr(tracing, "device_sync", lambda dev: lambda: syncs.append(1))
        for listener in LISTENERS:
            syncs.clear()
            log = SpanLog()
            if listener == "enable":
                with tracing.enable():
                    settings, proof = _request(cx)
            elif listener == "logger":
                tracing.logger.addHandler(log)
                level = tracing.logger.level
                tracing.logger.setLevel(logging.INFO)
                records = []
                keep = logging.Handler()
                keep.emit = records.append
                tracing.logger.addHandler(keep)
                try:
                    settings, proof = _request(cx)
                finally:
                    tracing.logger.removeHandler(log)
                    tracing.logger.removeHandler(keep)
                    tracing.logger.setLevel(level)
                out["records"] = records
            else:
                settings, proof = _request(cx)
            req = tracing.requests()[-1]
            out[listener] = SimpleNamespace(settings=settings, proof=proof, request=req, syncs=len(syncs),
                                            spans=log.spans,
                                            phases={k: tracing.last_phases(k) for k in ("settings", "trace", "prove")})
    return out


def test_spans_nest_in_one_request_across_the_passes(runs):
    r = runs["none"]
    req = r.request
    assert req.id == r.settings.request and req.complete
    roots = [s.name for s in req.spans if s.parent == ""]
    assert roots == ["settings", "trace", "prove"]
    paths = {s.path for s in req.spans}
    for s in req.spans:
        assert s.parent == "" or s.parent in paths, s.path
        assert 0 < s.start_ns <= s.end_ns
    for p in ("settings/walk", "settings/launches/lut_f", "settings/flags/download",
              "settings/flags/settings_from_ranges", "trace/walk", "prove/phase0_preprocessed/build",
              "prove/phase0_preprocessed/upload", "prove/phase0_preprocessed/commit", "prove/phase1_main/columns",
              "prove/phase1_main/commit", "prove/self_check/oods_composition", "prove/self_check/replay",
              "prove/phase3b_oods_fri/3b_decommit/3b_decommit.plan"):
        assert p in paths, p
    # A child lies inside its parent.
    by_path = {s.path: s for s in req.spans}
    for s in req.spans:
        if s.parent:
            parent = by_path[s.parent]
            assert parent.start_ns <= s.start_ns and s.end_ns <= parent.end_ns, s.path
    # Each pass of another request has another id.
    assert runs["enable"].request.id != req.id


def test_the_settings_bytes_carry_no_request_id(runs):
    s = runs["none"].settings
    bare = copy.copy(s)
    del bare.request
    assert not hasattr(bare, "request") and s.request
    assert serde.settings_to_flat_bytes(s) == serde.settings_to_flat_bytes(bare)
    assert s == bare


@pytest.mark.parametrize("kind,keys", [
    ("prove", PROVE_PHASES + ("3b_oods_eval", "3b_quotients", "3b_fri_commit", "3b_pow", "3b_decommit",
                              "3b_quotients.constants", "3b_quotients.plan", "3b_quotients.launch",
                              "3b_decommit.positions", "3b_decommit.plan", "3b_decommit.launch_download",
                              "3b_decommit.assembly", "total")),
    ("settings", ("plan", "walk", "allocate", "pack", "upload", "launches", "lut_boundary", "lut_download", "lut_f",
                  "lut_upload", "flags", "total")),
    ("trace", ("plan", "walk", "allocate", "pack", "upload", "launches", "download", "assembly", "total")),
])
def test_last_phases_keeps_its_keys(runs, kind, keys):
    phases = runs["none"].phases[kind]
    assert set(keys) <= set(phases)
    assert all(isinstance(v, float) and v >= 0 for v in phases.values())


@pytest.fixture(scope="module")
def totals():
    """The latest passes' totals just after a request and 0.05 s later,
    and the request."""
    _request(_graph())
    first = {k: tracing.last_phases(k)["total"] for k in ("settings", "trace", "prove")}
    time.sleep(0.05)
    later = {k: tracing.last_phases(k)["total"] for k in ("settings", "trace", "prove")}
    return first, later, tracing.requests()[-1]


@pytest.mark.parametrize("kind", ["settings", "trace", "prove"])
def test_total_is_the_root_span_and_stays(totals, kind):
    first, later, req = totals
    (root,) = [s for s in req.spans if s.parent == "" and s.name == kind]
    assert later[kind] == first[kind] == root.seconds > 0


@pytest.mark.parametrize("listener", LISTENERS)
def test_spans_synchronise_only_for_a_listener(runs, listener):
    """Without a listener only the prove's phases end with a synchronise;
    with one every span does, its root's too."""
    r = runs[listener]
    spans = r.request.spans
    if listener == "none":
        assert r.syncs == len([s for s in spans if s.parent == "prove"]) == len(PROVE_PHASES)
    else:
        assert r.syncs == len(spans)


def test_the_logger_records_parse_as_the_benchmark_reads_them(runs):
    r = runs["logger"]
    below = [s for s in r.request.spans if s.parent]
    assert [(k, n) for k, n, _, _ in r.spans] == [(s.parent.split("/")[0], s.name) for s in
                                                  sorted(below, key=lambda s: s.end_ns)]
    assert all(isinstance(sec, float) for _, _, sec, _ in r.spans)
    extras = {(rec.span_path, rec.request_id) for rec in runs["records"]}
    assert extras == {(s.path, r.request.id) for s in below}
    assert all(rec.end_ns >= rec.start_ns for rec in runs["records"])


def test_the_spans_are_ranges_on_the_profilers_clock(tmp_path):
    """Nested function-scope ranges: a user-scope range would also be drawn
    on the device's timeline, where the benchmark's profile counts every
    record as device work."""
    import json

    from torch.profiler import ProfilerActivity, profile

    cx = _graph()
    settings = T.gen_circuit_settings(cx, device="cpu")
    pie = T.gen_trace(cx, settings, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        T.prove(pie, settings, CFG, device="cpu")
    ranges = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith(tracing.RANGE_PREFIX):
            ranges.setdefault(e.name(), []).append((e.start_ns(), e.start_ns() + e.duration_ns()))
    paths = {s.path for s in tracing.requests()[-1].spans if s.path.startswith("prove")}
    assert set(ranges) == {tracing.RANGE_PREFIX + p for p in paths}
    (outer,) = ranges["lum.prove/phase0_preprocessed"]
    (inner,) = ranges["lum.prove/phase0_preprocessed/upload"]
    assert outer[0] <= inner[0] and inner[1] <= outer[1]
    (root,) = ranges["lum.prove"]
    assert all(root[0] <= a and b <= root[1] for v in ranges.values() for a, b in v)
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    assert {e.get("cat") for e in events if e.get("name", "").startswith(tracing.RANGE_PREFIX)} == {"cpu_op"}


def _host(nbytes, pinned=False):
    return SimpleNamespace(is_cuda=False, device=torch.device("cpu"), is_pinned=lambda: pinned,
                           numel=lambda: nbytes // 4, element_size=lambda: 4,
                           to=lambda device, non_blocking=False: "to", cpu=lambda: "cpu",
                           copy_=lambda src, non_blocking=False: "copy")


def _card(nbytes):
    t = _host(nbytes)
    t.is_cuda, t.device = True, torch.device("cuda", 0)
    return t


@pytest.mark.parametrize("case,kind,nbytes", [
    ("to_device pageable", tracing.H2D_PAGEABLE, 4096),
    ("to_device pinned", tracing.H2D_PINNED, 1024),
    ("copy pageable", tracing.H2D_PAGEABLE, 64),
    ("copy pinned", tracing.H2D_PINNED, 128),
    ("copy down", tracing.D2H, 256),
    ("to_host", tracing.D2H, 512),
    ("to_device on the host", None, 8),
    ("to_device between cards", None, 8),
])
def test_the_copy_helpers_count_bytes_by_kind_under_the_span_in_flight(case, kind, nbytes):
    pinned = "pinned" in case
    before = dict(tracing._totals)
    with tracing.root("copies") as rid:
        with tracing.span("outer"):
            with tracing.span("inner"):
                if case.startswith("to_device"):
                    dst = "cpu" if "host" in case else "cuda"
                    src = _card(nbytes) if "cards" in case else _host(nbytes, pinned)
                    assert f.to_device(src, dst, non_blocking=True) == "to"
                elif case == "copy down":
                    assert f.copy(_host(nbytes), _card(nbytes)) == "copy"
                elif case.startswith("copy"):
                    assert f.copy(_card(nbytes), _host(nbytes, pinned), non_blocking=True) == "copy"
                else:
                    assert f.to_host(_card(nbytes)) == "cpu"
    req = tracing.requests()[-1]
    assert req.id == rid
    by_path = {s.path: s.counts for s in req.spans}
    want = {kind: nbytes} if kind else {}
    assert by_path == {"copies": {}, "copies/outer": {}, "copies/outer/inner": want}
    assert req.counters() == want
    grown = {k: v - before.get(k, 0) for k, v in tracing._totals.items() if v != before.get(k, 0)}
    assert grown == want


@pytest.mark.parametrize("shard", [None, 0, "lead"])
def test_the_launch_counters_are_views_of_the_store(shard):
    kernels.reset_counts()
    with tracing.root("launches"):
        with kernels.on_shard(shard) if shard is not None else tracing.span("no shard"):
            tracing.launch(kernels.MERKLE.name)
            tracing.launch(kernels.MERKLE.name)
            tracing.count("hosted." + kernels.CHANNEL.name)
    assert kernels.MERKLE.launches == 2 and kernels.CHANNEL.hosted == 1
    assert kernels.counts()[kernels.MERKLE.name] == 2 and sum(kernels.counts().values()) == 2
    assert dict(kernels.SHARD_LAUNCHES) == ({} if shard is None else {shard: {kernels.MERKLE.name: 2}})
    counters = tracing.requests()[-1].counters()
    assert counters["launches." + kernels.MERKLE.name] == 2
    kernels.reset_counts()
    assert kernels.MERKLE.launches == 0 and kernels.CHANNEL.hosted == 0 and not kernels.SHARD_LAUNCHES


def test_the_history_stays_bounded(monkeypatch):
    monkeypatch.setattr(tracing, "HISTORY", 4)
    ids = []
    for _ in range(7):
        with tracing.root("bounded") as rid:
            with tracing.span("inside"):
                pass
        ids.append(rid)
    kept = tracing.requests()
    assert len(kept) == 4 and [q.id for q in kept] == ids[-4:]
    assert all([s.path for s in q.spans] == ["bounded", "bounded/inside"] for q in kept)
    assert tracing.HISTORY >= 4 and not any(q.complete for q in kept)


@pytest.mark.parametrize("fault", ["body", "sync"])
def test_a_failing_pass_is_recorded_and_leaves_nothing_open(monkeypatch, fault):
    """An exception in a span's body, or from the device synchronise that
    ends it, ends every span, records the pass as failed and leaves no pass
    in flight for the next one."""
    def sync():
        if fault == "sync":
            raise RuntimeError("synchronise failed")

    monkeypatch.setattr(tracing, "device_sync", lambda dev: sync)
    with tracing.enable(), pytest.raises(RuntimeError):
        with tracing.root("failing", device="cpu"):
            with tracing.span("inner"):
                if fault == "body":
                    raise RuntimeError("body failed")
    assert not tracing._passes
    req = tracing.requests()[-1]
    assert [(s.path, s.ok, s.end_ns >= s.start_ns > 0) for s in req.spans] == [
        ("failing", False, True), ("failing/inner", fault == "sync", True)]
    with tracing.root("after") as rid:
        pass
    assert tracing.requests()[-1].id == rid and [s.path for s in tracing.requests()[-1].spans] == ["after"]
