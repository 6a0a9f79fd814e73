"""The share of the profiled window in which no kernel and no copy ran on
the card.  The profiler lengthens the host's part, so this is an upper
estimate."""

LAYER = "device"
UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "proved_cells_per_s"


def read(r):
    p = r.profile
    return 100.0 * (1.0 - p.busy_s / p.window_s) if p and p.window_s > 0 else None
