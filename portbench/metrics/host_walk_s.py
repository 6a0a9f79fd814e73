"""Seconds a request spends in the host's walks of the graph: the program's
spans settings/walk and trace/walk (the layout of every node, table and
segment), read from its history of requests."""

from portbench import spans

LAYER = "trace and settings"
UNIT = "s"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "proved_cells_per_s"
PATHS = ("settings/walk", "trace/walk")


def read(r):
    """Mean seconds a request of the traced window."""
    from luminair_tpu_torch import tracing

    return spans.mean(spans.window(r, tracing), lambda q: sum(q.seconds(p) for p in PATHS))
