"""Seconds a prove spends on the OODS values, the DEEP quotients, FRI, the
proof of work and the decommitment: the program's prove span
phase3b_oods_fri."""

LAYER = "prover phases: OODS, FRI, PoW, decommit"
UNIT = "s"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "proved_cells_per_s"
STAGES = ("phase3b_oods_fri",)


def read(r):
    """Mean seconds a request of the traced window."""
    return r.mean_stage(*STAGES) if r.done else None
