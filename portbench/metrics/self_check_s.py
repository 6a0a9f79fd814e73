"""Seconds a prove spends checking its own proof at the OODS point before it
returns: the program's prove span self_check."""

LAYER = "host work inside the prove"
UNIT = "s"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "proved_cells_per_s"
STAGES = ("self_check",)


def read(r):
    """Mean seconds a request of the traced window."""
    return r.mean_stage(*STAGES) if r.done else None
