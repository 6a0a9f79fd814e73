"""Phase-level tracing for the prover.

A `PhaseTimer` collects wall-clock seconds per named phase; the most recent
prove timer is kept module-global so benchmarks can report per-phase
breakdowns without threading a handle through the public API.  CUDA work is
asynchronous, so a timer made with `sync` (torch.cuda.synchronize for a
prove on the card) calls it at the end of every span: a span then holds the
device time of the work it launched.

Each span logs one line to the ``luminair_tpu_torch`` logger at INFO.
"""

from __future__ import annotations

import contextlib
import logging
import time
from typing import Callable, Dict, Optional

logger = logging.getLogger("luminair_tpu_torch")


class PhaseTimer:
    """Accumulates wall-clock seconds per named phase."""

    def __init__(self, kind: str, sync: Optional[Callable[[], None]] = None):
        self.kind = kind
        self.phases: Dict[str, float] = {}
        self._sync = sync
        self._t_start = time.perf_counter()

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self._sync is not None:
                self._sync()
            dt = time.perf_counter() - t0
            self.phases[name] = self.phases.get(name, 0.0) + dt
            logger.info("%s %s: %.4fs", self.kind, name, dt)

    def total(self) -> float:
        return time.perf_counter() - self._t_start

    def summary(self) -> Dict[str, float]:
        out = dict(self.phases)
        out["total"] = self.total()
        return out


_last: Dict[str, Optional[PhaseTimer]] = {"prove": None}


def start(kind: str, sync: Optional[Callable[[], None]] = None) -> PhaseTimer:
    t = PhaseTimer(kind, sync)
    _last[kind] = t
    return t


def current(kind: str) -> PhaseTimer:
    """The live timer of the in-flight prove() (a fresh detached timer if
    none is active -- sub-spans then go unreported)."""
    t = _last.get(kind)
    return t if t is not None else PhaseTimer(kind)


def last_phases(kind: str) -> Dict[str, float]:
    """Per-phase seconds of the most recent prove()."""
    t = _last.get(kind)
    return t.summary() if t else {}
