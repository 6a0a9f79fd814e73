"""What a request's statement fixes, whatever proves it: the trace tables
(rows, log size, columns), the proof's claim, the committed trees and the
PIE's cells.  Frozen here so that counts of work never follow the
program's launches.

COMPONENTS is the protocol's canonical component order (it fixes the
claim's encoding and the trees' layout) with each component's main
columns and its LogUp interaction columns (in QM31 columns of 4 words).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

from .reference import fixed as fx

COMPONENTS = (  # (name, main columns, interaction columns)
    ("add", 15, 3), ("mul", 16, 3), ("recip", 13, 2), ("sqrt", 13, 2), ("rem", 16, 3),
    ("sin", 12, 3), ("exp2", 12, 3), ("log2", 12, 3), ("less_than", 22, 7), ("sum_reduce", 14, 2),
    ("max_reduce", 20, 6), ("inputs", 7, 1), ("contiguous", 11, 2), ("sin_lookup", 1, 1),
    ("exp2_lookup", 1, 1), ("log2_lookup", 1, 1), ("range_check_lookup", 1, 1), ("square", 12, 2),
)
INDEX = {name: i for i, (name, _, _) in enumerate(COMPONENTS)}
MAIN = {name: m for name, m, _ in COMPONENTS}
INTERACTION = {name: k for name, _, k in COMPONENTS}


@dataclass
class Pcs:
    """A PCS profile as a mix file states it."""

    pow_bits: int
    log_blowup: int
    n_queries: int
    folds_per_layer: int
    log_last_layer_degree_bound: int

    @property
    def security_bits(self) -> int:
        return self.pow_bits + self.log_blowup * self.n_queries


@dataclass
class Statement:
    rows: Dict[str, int]  # trace table -> rows before padding
    lut_logs: Dict[str, int] = field(default_factory=dict)  # LUT kind -> table log size
    range_check_bits: int = 0

    @staticmethod
    def of(tape: fx.Tape, lut_logs: Dict[str, int]) -> "Statement":
        rows = {k: v for k, v in tape.rows.items() if v}
        for kind, log in lut_logs.items():
            rows[f"{kind}_lookup"] = 1 << log
        bits = 8 if tape.range_check else 0
        if bits:
            rows["range_check_lookup"] = 1 << bits
        return Statement(rows, dict(lut_logs), bits)

    @property
    def names(self) -> List[str]:
        return [name for name, _, _ in COMPONENTS if name in self.rows]

    @property
    def claim(self) -> Dict[str, int]:
        """Component -> log size, as the proof states them."""
        return {n: fx.log_size(self.rows[n]) for n in self.names}

    @property
    def cells(self) -> int:
        """PIE cells: rows times main columns, before padding."""
        return sum(self.rows[n] * MAIN[n] for n in self.names)

    def trees(self, B: int) -> List[Dict[int, int]]:
        """Columns by trace log of the four committed trees: preprocessed
        (an is_first column per trace log, two per LUT, the range check's),
        main, interaction, composition (4 columns at the largest log + 1)."""
        claim = self.claim
        pp, main, inter = {}, {}, {}
        for name in self.names:
            log = claim[name]
            pp[log] = 1
            main[log] = main.get(log, 0) + MAIN[name]
            inter[log] = inter.get(log, 0) + 4 * INTERACTION[name]
        for log in self.lut_logs.values():
            pp[log] = pp.get(log, 0) + 2
        if self.range_check_bits:
            pp[self.range_check_bits] = pp.get(self.range_check_bits, 0) + 1
        return [pp, main, inter, {max(claim.values()) + 1: 4}]

    def last_layer_bound(self, pcs: Pcs) -> int:
        """The FRI last layer's degree bound the proof states: the mix's,
        clamped to what the smallest committed column admits."""
        smallest = min(min(t) for t in self.trees(pcs.log_blowup)) + pcs.log_blowup
        return max(0, min(pcs.log_last_layer_degree_bound, smallest - 1 - pcs.log_blowup))

    def fri_layers(self, pcs: Pcs) -> List[int]:
        """Line log of each committed FRI layer (a tree of 4 columns each)."""
        B = pcs.log_blowup
        kmax = max(self.claim.values()) + 1 + B
        last = B + self.last_layer_bound(pcs)
        out, log = [], kmax - 1
        while log > last:
            out.append(log)
            log -= min(pcs.folds_per_layer, log - last)
        return out
