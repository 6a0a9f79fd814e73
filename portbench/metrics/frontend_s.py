"""Seconds a request spends handing its inputs to the graph (GraphTensor.set),
reading the retrieved outputs and writing the proof's flat bytes: the
benchmark's spans around those calls."""

LAYER = "front end"
UNIT = "s"
BETTER = "lower"
SOURCE = "host_clock"
MOVES = "proved_cells_per_s"
STAGES = ("frontend",)


def read(r):
    """Mean seconds a request of the traced window."""
    return r.mean_stage(*STAGES) if r.done else None
