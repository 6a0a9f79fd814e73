"""Seconds a prove spends building and committing the preprocessed columns:
the program's prove span phase0_preprocessed."""

LAYER = "host work inside the prove"
UNIT = "s"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "proved_cells_per_s"
STAGES = ("phase0_preprocessed",)


def read(r):
    """Mean seconds a request of the traced window."""
    return r.mean_stage(*STAGES) if r.done else None
