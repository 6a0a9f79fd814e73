"""Claims: per-component trace sizes and LogUp claimed sums, mixed into the
Fiat-Shamir channel in canonical component order."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np

from ..fields import P
from .components import ALL_COMPONENTS


@dataclass
class LuminairClaim:
    log_sizes: Dict[str, int]  # component name -> log_size (present only)

    def mix_into(self, channel):
        data = []
        for idx, comp in enumerate(ALL_COMPONENTS):
            if comp.name in self.log_sizes:
                data.extend([idx, self.log_sizes[comp.name]])
        channel.mix_u32s(np.asarray(data, dtype=np.uint32))

    @property
    def max_log_size(self) -> int:
        return max(self.log_sizes.values())


@dataclass
class LuminairInteractionClaim:
    sums: Dict[str, np.ndarray]  # component name -> (4,) uint32 claimed sum

    def mix_into(self, channel):
        for comp in ALL_COMPONENTS:
            if comp.name in self.sums:
                channel.mix_felts(np.asarray(self.sums[comp.name], dtype=np.uint32))

    def total(self) -> np.ndarray:
        acc = np.zeros(4, dtype=np.int64)
        for s in self.sums.values():
            acc = (acc + np.asarray(s, dtype=np.int64)) % P
        return acc.astype(np.uint32)

    def is_balanced(self) -> bool:
        """The global LogUp sum must vanish."""
        return bool(np.all(self.total() == 0))
