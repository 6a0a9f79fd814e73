"""Seconds a request spends on the host's lookup-table work in the settings
pass: the program's spans settings/launches/lut_f (f of each LUT node's
inputs in float64) and settings/flags/settings_from_ranges (the tables
built from the ranges), read from its history of requests."""

from portbench import spans

LAYER = "trace and settings"
UNIT = "s"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "proved_cells_per_s"
PATHS = ("settings/launches/lut_f", "settings/flags/settings_from_ranges")


def read(r):
    """Mean seconds a request of the traced window."""
    from luminair_tpu_torch import tracing

    return spans.mean(spans.window(r, tracing), lambda q: sum(q.seconds(p) for p in PATHS))
