"""Constraint debugging: every component's constraints evaluated on the
trace domain, and the rows where each one fails.

The counterpart of the JAX package's air/debug.py, with the same result.  A
failure elsewhere shows only as a verifier's rejection; this names the
component, the constraint (its index in the order `evaluate` emits them,
the LogUp constraints after the recorded ones, one per relation entry) and
the first rows where it does not vanish.

On the card (the default): the PIE's columns are read where they lie (a
card PIE's `padded` tensors; host words are uploaded), the preprocessed
columns are uploaded once, and one launch of K5
(`kernels.air_witness_many`) builds every component's interaction and
claimed sum as the prover does; then one launch of
`kernels.air_check_many` writes one word per row of every component, a
bit per failing constraint.  One download of the (C, 4) claimed sums, one
`torch.nonzero` over the words and one download of the rows it finds.
device="cpu" runs the same steps through the kernels' plain twins.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from .. import fields as f
from .. import kernels
from ..crypto.channel import Blake2sChannel
from ..prover import _main_column, resolve_device
from . import tape
from .claim import LuminairClaim
from .layout import AirLayout

FIRST_ROWS = 8  # rows reported for each failing constraint


def check_pie_constraints(pie, settings, device=None) -> Dict[str, List[tuple]]:
    """{component: [(constraint_idx, bad_rows), ...]} for every constraint
    that does not vanish on the trace domain, with the first FIRST_ROWS
    rows where it does not; {} for an honest PIE.  Components without rows
    are left out.  The lookup elements are drawn from a channel that has
    mixed b"debug"."""
    dev = resolve_device(device)
    tables = {n: t for n, t in pie.trace_tables.items() if t.n_rows > 0}
    layout = AirLayout(LuminairClaim({n: t.log_size for n, t in tables.items()}), settings)
    ch = Blake2sChannel()
    ch.mix_bytes(b"debug")
    ew = tape.element_words(layout.draw_elements(ch))
    pp = dict(zip(layout.pp.ids(), (f.u32_to_tensor(c, dev) for c in layout.pp.columns())))

    comps = []
    for c in layout.components:
        padded = tables[c.name].padded_columns(c.MAIN)
        comps.append((c, [_main_column(padded[n], dev) for n in c.MAIN], [pp[p] for p in c.PP_IDS]))
    inters, claimed = kernels.air_witness_many([(tape.record(c, witness=True), main, pp_cols)
                                                for c, main, pp_cols in comps], ew)
    sums = f.tensor_to_u32(claimed)
    every = kernels.air_check_many(
        [(tape.record(c), main, pp_cols, list(inter.unbind(0)), pp[layout.is_first_id(c.name)], s)
         for (c, main, pp_cols), inter, s in zip(comps, inters, sums)], ew)
    at = torch.nonzero(every).flatten()
    at, bits = f.to_host(torch.stack([at, every[at].to(f.I64) & 0xFFFFFFFF])).numpy()

    out = {}
    start = 0
    for (c, _, _), inter in zip(comps, inters):
        n = inter.shape[1]
        here = (at >= start) & (at < start + n)
        rows, row_bits = at[here] - start, bits[here]
        fails = []
        for i in range(tape.record(c).n_pows):
            bad = rows[(row_bits >> i) & 1 == 1]
            if len(bad):
                fails.append((i, bad[:FIRST_ROWS].tolist()))
        if fails:
            out[c.name] = fails
        start += n
    return out
