"""Seconds a prove spends committing the main trace, building and committing
the LogUp interaction columns and the composition polynomial: the
program's prove spans phase1_main, phase2_interaction and
phase3a_composition."""

LAYER = "prover phases: commits and AIR"
UNIT = "s"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "proved_cells_per_s"
STAGES = ("phase1_main", "phase2_interaction", "phase3a_composition")


def read(r):
    """Mean seconds a request of the traced window."""
    return r.mean_stage(*STAGES) if r.done else None
