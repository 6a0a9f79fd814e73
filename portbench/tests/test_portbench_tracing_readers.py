"""The readers of the program's spans and counters (metrics/host_walk_s.py,
host_lut_s.py, h2d_pageable_mb.py): the traced window's requests chosen
from the program's history, and None where they are missing."""

import time
from types import SimpleNamespace

import pytest

from conftest import SEED

READERS = ("host_walk_s", "host_lut_s", "h2d_pageable_mb")


def _request(i, walk, lut, pageable, complete=True):
    """A request of the program's history: its passes' spans, `walk`
    seconds in each walk, `lut` in each host LUT span, `pageable` bytes
    uploaded in phase 0."""
    from luminair_tpu_torch import tracing

    ns = int(1e9)
    spans = [tracing.Span("settings", "", 0, ns), tracing.Span("walk", "settings", 0, int(walk * ns)),
             tracing.Span("launches", "settings", 0, ns), tracing.Span("lut_f", "settings/launches", 0, int(lut * ns)),
             tracing.Span("flags", "settings", 0, ns),
             tracing.Span("settings_from_ranges", "settings/flags", 0, int(lut * ns)),
             tracing.Span("trace", "", 0, ns), tracing.Span("walk", "trace", 0, int(walk * ns)),
             tracing.Span("prove", "", 0, ns, ok=complete), tracing.Span("phase0_preprocessed", "prove", 0, ns),
             tracing.Span("upload", "prove/phase0_preprocessed", 0, ns,
                          counts={tracing.H2D_PAGEABLE: pageable, tracing.H2D_PINNED: 7}),
             tracing.Span("phase3b_oods_fri", "prove", 0, ns, counts={tracing.D2H: 5})]
    return tracing.Request(i, spans)


def _history(monkeypatch, requests):
    from luminair_tpu_torch import tracing

    monkeypatch.setattr(tracing, "requests", lambda: list(requests))


def _read(name, done, profiled):
    from portbench import loader

    r = SimpleNamespace(done=[object()] * done, profile=None if profiled is None else SimpleNamespace(
        requests=profiled))
    return loader.reader(name).read(r)


# Requests 1-2 warm, 3-6 the window (5 failed its prove), 7-8 profiled.
HISTORY = [(1, 9.0, 9.0, 9), (2, 9.0, 9.0, 9), (3, 1.0, 0.5, 2_000_000), (4, 2.0, 0.25, 4_000_000),
           (5, 9.0, 9.0, 9, False), (6, 3.0, 0.75, 6_000_000), (7, 8.0, 8.0, 8), (8, 8.0, 8.0, 8)]


@pytest.mark.parametrize("name,want", [("host_walk_s", 2 * 2.0), ("host_lut_s", 2 * 0.5),
                                       ("h2d_pageable_mb", 4.0)])
def test_each_reader_reads_the_traced_windows_requests(monkeypatch, name, want):
    """The last len(done) complete requests before the profiled window's."""
    _history(monkeypatch, [_request(*h) for h in HISTORY])
    assert _read(name, 3, 2) == pytest.approx(want)


@pytest.mark.parametrize("name", READERS)
def test_without_a_profiled_window_the_window_ends_the_history(monkeypatch, name):
    _history(monkeypatch, [_request(*h) for h in HISTORY[:6]])
    assert _read(name, 3, None) == pytest.approx(_read(name, 3, 0)) == pytest.approx(
        {"host_walk_s": 4.0, "host_lut_s": 1.0, "h2d_pageable_mb": 4.0}[name])


@pytest.mark.parametrize("name", READERS)
@pytest.mark.parametrize("done,profiled", [(6, 2), (8, None), (0, None)])
def test_a_reader_gives_none_where_requests_are_missing(monkeypatch, name, done, profiled):
    _history(monkeypatch, [_request(*h) for h in HISTORY])
    assert _read(name, done, profiled) is None


@pytest.mark.parametrize("name", READERS)
def test_a_program_without_a_history_gives_none(monkeypatch, name):
    """The parent of this benchmark's readers keeps no history: each reader
    returns None and raises nothing."""
    from luminair_tpu_torch import tracing

    monkeypatch.delattr(tracing, "requests")
    assert _read(name, 1, None) is None


def test_no_copy_counted_gives_no_copy_reading(monkeypatch):
    """A run on the CPU copies nothing between host and card."""
    reqs = [_request(*h) for h in HISTORY]
    for q in reqs:
        for s in q.spans:
            s.counts = {}
    _history(monkeypatch, reqs)
    assert _read("h2d_pageable_mb", 3, 2) is None and _read("host_walk_s", 3, 2) == pytest.approx(4.0)


def test_a_traced_cpu_run_reports_the_program_readings(tiny, monkeypatch):
    """A traced run of the tiny a*b + a cell reports host_walk_s and, with
    the phase-0 uploads counted as a card's pageable copies would be,
    h2d_pageable_mb: the mean bytes a request, from the program's store."""
    from luminair_tpu_torch import fields, tracing

    from portbench import harness

    real = fields.u32_to_tensor

    def counted(a, device="cpu", dtype=fields.I32):
        t = real(a, device, dtype)
        tracing.count(tracing.H2D_PAGEABLE, t.numel() * t.element_size())
        return t

    monkeypatch.setattr(fields, "u32_to_tensor", counted)
    r = harness.run(tiny, "mul_add.pcs20", SEED, 0.5, True, "cpu", time.perf_counter())
    assert r["correct"]
    m = r["metrics"]
    assert m["host_walk_s"]["unit"] == "s" and m["host_walk_s"]["value"] > 0
    assert m["h2d_pageable_mb"]["unit"] == "MB" and m["h2d_pageable_mb"]["value"] > 0
    assert "host_lut_s" not in m  # the cell has no lookup table and is not in the metric's cells
    window = [q for q in tracing.requests() if q.complete][-r["attempted"]:]
    assert m["h2d_pageable_mb"]["value"] == pytest.approx(
        sum(q.counters()[tracing.H2D_PAGEABLE] for q in window) / len(window) / 1e6)
