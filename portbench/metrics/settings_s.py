"""Seconds of gen_circuit_settings a request: the benchmark's span around
the call, ended by a synchronise."""

LAYER = "trace and settings"
UNIT = "s"
BETTER = "lower"
SOURCE = "host_clock"
MOVES = "proved_cells_per_s"
STAGES = ("settings",)


def read(r):
    """Mean seconds a request of the traced window."""
    return r.mean_stage(*STAGES) if r.done else None
