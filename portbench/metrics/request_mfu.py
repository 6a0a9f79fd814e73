"""The whole request's share of the card's peak: the least time of the work
the statement asks for (work.request: the trace's columns written, the
trees' transforms and hashing, summed before the bound) over the wall
time of the profiled window's requests.  Work the statement does not yet
count (the LogUp columns, the constraints, OODS, quotients, FRI folds,
decommitment) is left out, so this is a lower bound."""

LAYER = "device"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
MOVES = "proved_cells_per_s"


def read(r):
    p = r.profile
    if not p or p.window_s <= 0 or not r.work:
        return None
    total = None
    for w in r.work.values():
        total = w if total is None else total + w
    return 100.0 * total.seconds / p.window_s
