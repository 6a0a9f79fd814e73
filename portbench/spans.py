"""The traced window's requests as the program recorded them: its spans and
counters (luminair_tpu_torch.tracing's history of requests), for the
per-layer readers that read them."""

from __future__ import annotations


def window(r, tracing):
    """The program's records of the traced window's requests: the last
    len(r.done) complete requests recorded before the profiled window's
    (r.profile.requests of them; none where r.profile is None).  None where
    the program keeps no such history or it holds fewer."""
    history = getattr(tracing, "requests", None)
    n = len(r.done)
    if history is None or not n:
        return None
    done = [q for q in history() if q.complete]
    if r.profile is not None:
        done = done[: max(0, len(done) - r.profile.requests)]
    return done[-n:] if len(done) >= n else None


def mean(requests, value):
    """The mean of value(request) over `requests`; None where they are None."""
    return None if requests is None else sum(value(q) for q in requests) / len(requests)
