"""A profiled window of whole requests on the card, and what the benchmark
reads from it: device time by kernel name, the busy time (the union of
every kernel's and copy's interval), the window's length, the device
operations that took most time and the idle gaps by what the host was
doing.

The window opens with eight launches of a spinning kernel, awaited, and
10 ms of nothing, then marks its start: the profiler loses device records
at the start of a window, and the warm-up takes the loss.  The program's
spans come from its logger (kind, name, seconds, at the span's end) and
are placed on the profiler's clock by the mark.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Tuple

import torch

WARM_UP_LAUNCHES = 8
WARM_UP_CYCLES = 200_000
PAD_S = 0.01
MARK = "portbench.mark"
STAGE_PREFIX = "portbench."
TOP = 10
NAME_CHARS = 96  # a device operation's name in the breakdown, cut (template arguments run to kilobytes)


class SpanLog(logging.Handler):
    """The program's spans as its logger reports them: (kind, name,
    seconds, wall-clock ns at the span's end)."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.spans: List[Tuple[str, str, float, int]] = []

    def emit(self, record: logging.LogRecord) -> None:
        args = record.args
        if isinstance(args, tuple) and len(args) == 3 and isinstance(args[2], float):
            self.spans.append((str(args[0]), str(args[1]), args[2], int(record.created * 1e9)))


@dataclass
class Profile:
    window_s: float
    busy_s: float
    requests: int
    kernels: Dict[str, float] = field(default_factory=dict)  # device record name -> seconds
    gaps: Dict[str, float] = field(default_factory=dict)  # host activity -> idle seconds

    def kernel_s(self, names) -> float:
        return sum(s for k, s in self.kernels.items() if any(n in k for n in names))

    def breakdown(self) -> dict:
        top = sorted(self.kernels.items(), key=lambda kv: -kv[1])[:TOP]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[k[:NAME_CHARS], v] for k, v in top], "idle_gaps": [[k, v] for k, v in gaps]}


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def profiled(run: Callable[[], int], logger_name: str) -> Profile:
    """`run` (which returns how many requests it made) in a profiled
    window."""
    from torch.autograd import DeviceType
    from torch.autograd.profiler import record_function
    from torch.profiler import ProfilerActivity, profile

    log = logging.getLogger(logger_name)
    spans, level = SpanLog(), log.level
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(WARM_UP_LAUNCHES):
            torch.cuda._sleep(WARM_UP_CYCLES)
        torch.cuda.synchronize()
        time.sleep(PAD_S)
        log.addHandler(spans)
        log.setLevel(logging.INFO)
        try:
            wall_mark = time.time_ns()
            with record_function(MARK):
                t0 = time.perf_counter()
            n = run()
            torch.cuda.synchronize()
            window = time.perf_counter() - t0
        finally:
            log.removeHandler(spans)
            log.setLevel(level)
        time.sleep(PAD_S)

    mark, device, stages = None, [], []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        dur = e.duration_ns() if hasattr(e, "duration_ns") else int(e.duration_us() * 1e3)
        if e.device_type() != DeviceType.CPU:
            if not e.name().startswith(STAGE_PREFIX):  # the stages' annotations on the device's timeline
                device.append((start, start + dur, e.name()))
        elif e.name() == MARK:
            mark = start
        elif e.name().startswith(STAGE_PREFIX):
            stages.append((start, start + dur, e.name()[len(STAGE_PREFIX):]))
    if mark is None:
        raise RuntimeError("profiled window: no record of its start mark")
    w0, w1 = mark, mark + int(window * 1e9)
    inside = [(max(a, w0), min(b, w1), name) for a, b, name in device if b > w0 and a < w1]
    kernels: Dict[str, float] = {}
    for a, b, name in inside:
        kernels[name] = kernels.get(name, 0.0) + (b - a) / 1e9
    busy = _merge([(a, b) for a, b, _ in inside])
    offset = mark - wall_mark
    host = stages + [(end + offset - int(s * 1e9), end + offset, f"{kind}/{name}") for kind, name, s, end in spans.spans]
    gaps: Dict[str, float] = {}
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) // 2
        around = [(e - s, name) for s, e, name in host if s <= mid <= e]
        label = min(around)[1] if around else "between stages"
        gaps[label] = gaps.get(label, 0.0) + (b - a) / 1e9
    return Profile(window, sum(b - a for a, b in busy) / 1e9, n, kernels, gaps)
