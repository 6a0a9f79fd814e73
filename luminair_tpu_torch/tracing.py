"""Spans and counters of the port: one tree of spans a request.

A request is one user's inputs through the passes: `gen_circuit_settings`
makes its id and gives it to the settings it returns (`settings.request`,
an attribute outside the settings' bytes); `gen_trace`, `prove` and
`verify` with those settings add their passes to the same request (a pass
with settings that carry no id begins a request of its own).  A pass
(`settings`, `trace`, `prove`, `verify`) is a root span; every span opened
inside it nests under the span open when it started, and records its name,
its parent's path and its start and end on `time.perf_counter_ns()`.  A
span's path is its ancestors' names and its own, joined by "/":
``prove/phase0_preprocessed/upload``.

Counters add to the innermost open span and to process-wide totals: the
bytes of every copy between host and device by kind (`H2D_PAGEABLE`,
`H2D_PINNED`, `D2H`; fields.py's copy helpers count them), the input bytes
a trace or settings pass stages though they were not `set` since the graph's
last pass (`H2D_REPEAT`: 0 while the graph's resident encoding holds), the
input values a pass takes from that encoding without staging or encoding
them (`RESIDENT_INPUTS`; both graph/device_trace.py), each kernel's
launches (``launches.<kernel>``, and ``launches.<kernel>@<shard>`` under
`on_shard`) and the steps one kernel's launch ran for another
(``hosted.<kernel>``).  kernels.py's `counts()`, `SHARD_LAUNCHES` and
`Kernel.launches` / `hosted` read the totals since `reset_counts()`.

When a pass ends, its spans, with their counts, join its request's entry in
a bounded history: `requests()` gives the last `HISTORY` requests, oldest
first.  `last_phases(kind)` gives the latest pass of a kind as seconds by
span name (summed over spans of one name), with `total` its root's.

CUDA work is asynchronous, so a span holds the device time of the work it
launched only if it ends with a device synchronise.  Spans do so only while
someone listens: inside `enable()`, or while the ``luminair_tpu_torch``
logger is enabled for INFO (each span below a root then logs ``kind name:
seconds``, its path, request id and times in the record's `extra`).  The
phases of `prove` and `verify` (the spans right below their roots)
synchronise always (`root(..., phases_sync=True)`).  While a torch.profiler
session runs, each span is also a range of the profiler's host records
named ``lum.<path>``: the device trace then holds the spans on its own
clock, nested, and each kernel and copy falls under the innermost range
open at its call.
"""

from __future__ import annotations

import contextlib
import itertools
import logging
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import torch

logger = logging.getLogger("luminair_tpu_torch")

HISTORY = 1024  # requests kept
H2D_PAGEABLE, H2D_PINNED, D2H = "h2d_pageable", "h2d_pinned", "d2h"  # bytes copied
H2D_REPEAT = "h2d_repeat"  # bytes a trace or settings pass stages for inputs not `set` since the graph's last pass
RESIDENT_INPUTS = "resident_inputs"  # input values a trace or settings pass takes from the graph's resident encoding
RANGE_PREFIX = "lum."


@dataclass
class Span:
    name: str
    parent: str  # the parent's path; "" for a pass's root
    start_ns: int
    end_ns: int = 0
    counts: Dict[str, int] = field(default_factory=dict)  # counted while this span was the innermost open
    ok: bool = True  # False where the span ended by an exception

    @property
    def path(self) -> str:
        return f"{self.parent}/{self.name}" if self.parent else self.name

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


@dataclass
class Request:
    id: int
    spans: List[Span] = field(default_factory=list)  # each pass's spans in the order they began, its root first

    @property
    def complete(self) -> bool:
        """Whether a prove of the request returned its proof."""
        return any(s.parent == "" and s.name == "prove" and s.ok for s in self.spans)

    def seconds(self, path: str) -> float:
        """Seconds of the spans at `path`, summed."""
        return sum(s.seconds for s in self.spans if s.path == path)

    def counters(self) -> Dict[str, int]:
        """Every span's counts, summed by counter."""
        out: Dict[str, int] = {}
        for s in self.spans:
            for k, n in s.counts.items():
                out[k] = out.get(k, 0) + n
        return out


class _Pass:
    def __init__(self, kind: str, request: int, sync: Optional[Callable[[], None]], phases_sync: bool):
        self.kind, self.request, self.sync, self.phases_sync = kind, request, sync, phases_sync
        self.spans: List[Span] = []
        self.open: List[Span] = []
        self.ranges: list = []  # the open profiler ranges, one a span or None


_history: "OrderedDict[int, Request]" = OrderedDict()
_latest: Dict[str, List[Span]] = {}  # kind -> the spans of its latest pass, the root first
_passes: List[_Pass] = []  # passes in flight, the innermost last
_ids = itertools.count(1)
_enabled = 0
_totals: Dict[str, int] = {}  # every counter since the process began
_base: Dict[str, int] = {}  # the totals at reset_counts()
_shards: Dict[str, object] = {}  # shards entered since reset_counts(), by name
_shard: List[str] = []  # the shards in effect, innermost last


class enable:
    """Tracing on: every span ends with a device synchronise.  A call turns
    it on for good; as a context manager, for the block."""

    def __init__(self):
        global _enabled
        _enabled += 1

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        global _enabled
        _enabled -= 1
        return False


def listening() -> bool:
    return _enabled > 0 or logger.isEnabledFor(logging.INFO)


def device_sync(dev: torch.device) -> Optional[Callable[[], None]]:
    """What ends a synchronised span of work on `dev`."""
    return (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else None


def new_request() -> int:
    return next(_ids)


def request_of(settings) -> Optional[int]:
    return getattr(settings, "request", None)


def _profiling() -> bool:
    return torch.autograd._profiler_enabled()


def _range(path: str):
    """The span's range on the profiler's clock, while a profiler runs.  A
    function-scope range: a `torch.profiler.record_function` (user scope)
    would also be drawn on the device's timeline as an annotation, which a
    reader of device records takes for device work."""
    if not _profiling():
        return None
    r = torch._C._profiler._RecordFunctionFast(RANGE_PREFIX + path)
    r.__enter__()
    return r


@contextlib.contextmanager
def root(kind: str, request: Optional[int] = None, device=None, phases_sync: bool = False):
    """A pass of `kind` (on `device`) as the root span of request
    `request` (a new one when None); yields the request's id."""
    p = _Pass(kind, new_request() if request is None else request,
              device_sync(torch.device(device)) if device is not None else None, phases_sync)
    _passes.append(p)
    s = Span(kind, "", time.perf_counter_ns())
    p.spans.append(s)
    p.open.append(s)
    p.ranges.append(_range(kind))
    try:
        yield p.request
    except BaseException:
        s.ok = False
        raise
    finally:
        try:
            _end(p)
        finally:
            _passes.remove(p)
            req = _history.get(p.request)
            if req is None:
                req = _history[p.request] = Request(p.request)
                while len(_history) > HISTORY:
                    _history.popitem(last=False)
            req.spans.extend(p.spans)
            _latest[kind] = p.spans


@contextlib.contextmanager
def span(name: str):
    """A span under the one open in the pass in flight; nothing outside a
    pass."""
    if not _passes:
        yield
        return
    p = _passes[-1]
    s = Span(name, p.open[-1].path, time.perf_counter_ns())
    p.spans.append(s)
    p.open.append(s)
    p.ranges.append(_range(s.path))
    try:
        yield
    except BaseException:
        s.ok = False
        raise
    finally:
        _end(p)


def _end(p: _Pass) -> None:
    """Ends the innermost open span of `p`."""
    s, r = p.open.pop(), p.ranges.pop()
    depth = len(p.open)
    try:
        if p.sync is not None and (listening() or (p.phases_sync and depth == 1)):
            p.sync()
    finally:
        s.end_ns = time.perf_counter_ns()
        if r is not None:
            r.__exit__(None, None, None)
    if depth and logger.isEnabledFor(logging.INFO):
        logger.info("%s %s: %.4fs", p.kind, s.name, s.seconds,
                    extra={"span_path": s.path, "request_id": p.request, "start_ns": s.start_ns,
                           "end_ns": s.end_ns})


def count(key: str, n: int = 1) -> None:
    """Adds `n` to counter `key`: to the totals and to the innermost open
    span of the pass in flight."""
    _totals[key] = _totals.get(key, 0) + n
    if _passes:
        c = _passes[-1].open[-1].counts
        c[key] = c.get(key, 0) + n


def launch(kernel: str) -> None:
    """One launch of `kernel`, counted also under each shard in effect."""
    count("launches." + kernel)
    for name in dict.fromkeys(_shard):
        count(f"launches.{kernel}@{name}")


class on_shard:
    """While active, the launches made count also under `shard` (and under
    the shards of enclosing `on_shard` blocks)."""

    def __init__(self, shard):
        self.name = str(shard)
        _shards.setdefault(self.name, shard)

    def __enter__(self):
        _shard.append(self.name)
        return self

    def __exit__(self, *exc):
        _shard.pop()
        return False


def since_reset(key: str) -> int:
    return _totals.get(key, 0) - _base.get(key, 0)


def reset_counts() -> None:
    """Counts since now, for `since_reset` and `shard_launches`."""
    global _base
    _base = dict(_totals)
    _shards.clear()


def shard_launches() -> Dict[object, Dict[str, int]]:
    """{shard: {kernel: launches}} since `reset_counts()`, for each shard
    entered since."""
    out: Dict[object, Dict[str, int]] = {shard: {} for shard in _shards.values()}
    for key in _totals:
        if key.startswith("launches.") and "@" in key:
            kernel, name = key[len("launches."):].rsplit("@", 1)
            n = since_reset(key)
            if n and name in _shards:
                out[_shards[name]][kernel] = n
    return out


def requests() -> List[Request]:
    """The history: the last HISTORY requests, oldest first."""
    return list(_history.values())


def last_phases(kind: str) -> Dict[str, float]:
    """Seconds by span name of the latest pass of `kind` (spans of one name
    summed), and `total`, its root's; {} before any."""
    if kind not in _latest:
        return {}
    r, *below = _latest[kind]
    out: Dict[str, float] = {}
    for s in below:
        out[s.name] = out.get(s.name, 0.0) + s.seconds
    out["total"] = r.seconds
    return out
