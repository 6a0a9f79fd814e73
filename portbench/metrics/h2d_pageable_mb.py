"""Megabytes a request copies from pageable host memory to the card: the
program's counter h2d_pageable (fields.py's copy helpers), read from its
history of requests.  None where the requests copied nothing between host
and card at all: a run without one."""

from portbench import spans

LAYER = "host-to-device copies"
UNIT = "MB"
BETTER = "lower"
SOURCE = "program_counter"
MOVES = "proved_cells_per_s"
COUNTER = "h2d_pageable"
KINDS = ("h2d_pageable", "h2d_pinned", "d2h")


def read(r):
    """Mean megabytes (1e6 bytes) a request of the traced window."""
    from luminair_tpu_torch import tracing

    window = spans.window(r, tracing)
    counts = None if window is None else [q.counters() for q in window]
    if not counts or not any(k in c for c in counts for k in KINDS):
        return None
    return sum(c.get(COUNTER, 0) for c in counts) / len(counts) / 1e6
