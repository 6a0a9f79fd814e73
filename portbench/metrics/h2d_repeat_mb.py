"""Megabytes a request stages and uploads again for input tensors that were
not set since the graph's previous pass (the weights, in both passes of
every request): the program's counter h2d_repeat (graph/device_trace.py),
read from its history of requests.  None where the requests counted no
such bytes under that name: a program without the counter."""

from portbench import spans

LAYER = "host-to-device copies"
UNIT = "MB"
BETTER = "lower"
SOURCE = "program_counter"
MOVES = "proved_cells_per_s"
COUNTER = "h2d_repeat"


def read(r):
    """Mean megabytes (1e6 bytes) a request of the traced window."""
    from luminair_tpu_torch import tracing

    window = spans.window(r, tracing)
    counts = None if window is None else [q.counters() for q in window]
    if not counts or not all(COUNTER in c for c in counts):
        return None
    return sum(c[COUNTER] for c in counts) / len(counts) / 1e6
