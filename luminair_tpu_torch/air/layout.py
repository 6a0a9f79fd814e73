"""AirLayout: the deterministic mapping from (claim, settings) to tree
column layouts, preprocessed trace, interaction elements and OODS sample
points, shared by the prover and its self-check."""

from __future__ import annotations

from typing import Dict, List

import torch

from .. import circle
from .. import fields as f
from .claim import LuminairClaim
from .components import ALL_COMPONENTS
from .framework import LookupElements
from .preprocessed import LutPreProcessed, PreProcessedTrace, RangeCheckPreProcessed


class AirLayout:
    def __init__(self, claim: LuminairClaim, settings):
        self.claim = claim
        self.settings = settings
        self.components = [c for c in ALL_COMPONENTS if c.name in claim.log_sizes]
        assert self.components, "empty claim"

        # Preprocessed trace: is_first per present size + LUTs + range checks.
        is_first_logs = sorted({claim.log_sizes[c.name] for c in self.components})
        luts = []
        for kind in ("sin", "exp2", "log2"):
            layout = getattr(settings.lookups, kind)
            if layout is not None and f"{kind}_lookup" in claim.log_sizes:
                luts.append(LutPreProcessed(kind, layout))
        rcs = []
        if settings.lookups.range_check_bits and "range_check_lookup" in claim.log_sizes:
            rcs.append(RangeCheckPreProcessed(settings.lookups.range_check_bits))
        self.pp = PreProcessedTrace(is_first_logs, luts, rcs)
        self._pp_ids = self.pp.ids()
        self._pp_logs = self.pp.logs()

        # Main / interaction tree layouts.
        self.main_slices = {}
        self.inter_slices = {}  # in QM31-column units (x4 base columns)
        main_pos = 0
        inter_pos = 0
        self.main_logs = []
        self.inter_logs = []
        for c in self.components:
            log = claim.log_sizes[c.name]
            self.main_slices[c.name] = (main_pos, main_pos + len(c.MAIN))
            main_pos += len(c.MAIN)
            self.main_logs.extend([log] * len(c.MAIN))
            self.inter_slices[c.name] = (inter_pos, inter_pos + c.N_INTERACTION)
            inter_pos += c.N_INTERACTION
            self.inter_logs.extend([log] * (4 * c.N_INTERACTION))

        self.composition_log = claim.max_log_size + 1

    def draw_elements(self, channel) -> Dict[str, LookupElements]:
        """Draw order is fixed: node, then the present LUT relations.  The
        elements stay on the host: the kernels take them as words."""
        elems = {"node": LookupElements.draw(channel, 2)}
        for kind in ("sin", "exp2", "log2"):
            if f"{kind}_lookup" in self.claim.log_sizes:
                elems[kind] = LookupElements.draw(channel, 2)
        if "range_check_lookup" in self.claim.log_sizes:
            elems["range_check"] = LookupElements.draw(channel, 1)
        return elems

    def pp_index(self, pp_id: str) -> int:
        return self._pp_ids.index(pp_id)

    def pp_logs(self) -> List[int]:
        return self._pp_logs

    def is_first_id(self, comp_name: str) -> str:
        return f"is_first_{self.claim.log_sizes[comp_name]}"

    def sample_points(self, z):
        """Per-tree per-column OODS points.  Every column opens at z; each
        component's last interaction column (4 coords) also opens at
        z - G_n; main columns in a component's MAIN_NEXT also at z + G_n."""
        pts_pp = [[z] for _ in self._pp_ids]
        pts_main = [[z] for _ in self.main_logs]
        for c in self.components:
            if not c.MAIN_NEXT:
                continue
            log = self.claim.log_sizes[c.name]
            z_next = circle.point_add_qm31(z, circle.point_to_qm31(circle.group_gen(log)))
            s0, _ = self.main_slices[c.name]
            for name in c.MAIN_NEXT:
                pts_main[s0 + c.MAIN.index(name)].append(z_next)
        pts_inter = []
        for c in self.components:
            log = self.claim.log_sizes[c.name]
            z_prev = circle.point_sub_qm31(z, circle.point_to_qm31(circle.group_gen(log)))
            for b in range(c.N_INTERACTION):
                pts = [z, z_prev] if b == c.N_INTERACTION - 1 else [z]
                for _coord in range(4):
                    pts_inter.append(list(pts))
        pts_comp = [[z] for _ in range(4)]
        return [pts_pp, pts_main, pts_inter, pts_comp]


def recombine_qm31(coords: List[torch.Tensor]) -> torch.Tensor:
    """[c0, c1, c2, c3] QM31 scalars (values of the 4 coordinate columns)
    -> the QM31 column's value c0 + c1*i + c2*u + c3*iu."""
    acc = f.qm31_zero(())
    for k, c in enumerate(coords):
        basis = torch.zeros(4, dtype=f.I64)
        basis[k] = 1
        acc = f.add(acc, f.qm31_mul(c, basis))
    return acc
