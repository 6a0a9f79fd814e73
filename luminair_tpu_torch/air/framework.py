"""AIR constraint framework: one `evaluate()` per component, two
interpreters.

A component defines its constraints once against the `AirEval` API:

    cols = ev.main(name)               # named main-trace columns
    ev.constraint(expr)                # expr must vanish on the trace
    ev.relation(elements, mult, vals)  # LogUp entry: mult / combine(vals)

interpreted by
  * TapeEval (air/tape.py) -- records the component as a straight-line
    program that the witness and domain kernels run row by row (the
    prover's phases 2 and 3a);
  * PointEval -- OODS-sampled QM31 scalars (int64 (4,) tensors); the
    combination sum(alpha^i * C_i) at the sample point (the prover's
    self-check).

LogUp (reference package air/framework.py): column b
carries the within-row chain S_b = S_{b-1} + n_b/d_b; the last column also
carries the running prefix sum down the rows.
  b < last: (S_b - S_{b-1}) * d_b - n_b = 0
  last:     (S - S_prev_row - S_{last-1} + is_first * claimed_sum) * d - n = 0
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import torch

from .. import fields as f


class Felt:
    """A QM31 value -- scalar (4,) or column (N, 4) int64."""

    __slots__ = ("v",)

    def __init__(self, v: torch.Tensor):
        self.v = v

    def _coerce(self, other):
        if isinstance(other, Felt):
            return other.v
        if isinstance(other, int):
            return f.qm31_from_ints(other, device=self.v.device)
        return other

    def __add__(self, other):
        return Felt(f.add(self.v, self._coerce(other)))

    __radd__ = __add__

    def __sub__(self, other):
        return Felt(f.sub(self.v, self._coerce(other)))

    def __rsub__(self, other):
        return Felt(f.sub(self._coerce(other), self.v))

    def __mul__(self, other):
        return Felt(f.qm31_mul(self.v, self._coerce(other)))

    __rmul__ = __mul__

    def __neg__(self):
        return Felt(f.neg(self.v))


class LookupElements:
    """Channel-drawn (z, alpha); combine(values) = sum alpha^i v_i - z."""

    def __init__(self, z: torch.Tensor, alpha: torch.Tensor, size: int):
        self.z = z
        self.alpha = alpha
        self.size = size
        self._alpha_pows = [f.qm31_from_ints(1, device=z.device)]
        for _ in range(size - 1):
            self._alpha_pows.append(f.qm31_mul(self._alpha_pows[-1], alpha))

    @classmethod
    def draw(cls, channel, size: int):
        z = f.u32_to_tensor(channel.draw_felt(), "cpu", f.I64)
        alpha = f.u32_to_tensor(channel.draw_felt(), "cpu", f.I64)
        return cls(z, alpha, size)

    def combine(self, values: List[Felt]) -> Felt:
        assert len(values) == self.size
        acc = f.neg(self.z)
        for i, v in enumerate(values):
            acc = f.add(acc, f.qm31_mul(v.v, self._alpha_pows[i]))
        return Felt(acc)


@dataclass
class RelationEntry:
    numerator: Felt
    denominator: Felt


class AirEval:
    """Base interpreter: records relation entries."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.relation_entries: List[RelationEntry] = []

    def main(self, name: str) -> Felt:
        raise NotImplementedError

    def main_next(self, name: str) -> Felt:
        """The column at the NEXT row (cyclic); such columns are listed in the
        component's MAIN_NEXT (the verifier samples them at z + G_n)."""
        raise NotImplementedError

    def preprocessed(self, pp_id: str) -> Felt:
        raise NotImplementedError

    def constraint(self, expr: Felt):
        raise NotImplementedError

    def relation(self, elements: LookupElements, mult: Felt, values: List[Felt]):
        self.relation_entries.append(RelationEntry(mult, elements.combine(values)))

    def one(self):
        return Felt(f.qm31_from_ints(1, device=self.device))

    def const(self, x: int):
        return Felt(f.qm31_from_ints(x, device=self.device))


class ConstraintAccumulator:
    """sum(alpha^i * C_i) with the alpha power carried across components."""

    def __init__(self, alpha: torch.Tensor, shape, pow_: torch.Tensor):
        self.alpha = alpha
        self.acc = f.qm31_zero(shape, alpha.device)
        self.pow = pow_

    def add(self, expr: Felt):
        self.acc = f.add(self.acc, f.qm31_mul(expr.v, self.pow))
        self.pow = f.qm31_mul(self.pow, self.alpha)


class PointEval(AirEval):
    """Scalar evaluation at the OODS point."""

    def __init__(
        self,
        main_values: Dict[str, torch.Tensor],
        pp_values: Dict[str, torch.Tensor],
        interaction_values: List[torch.Tensor],  # value at z per entry
        interaction_prev_value: torch.Tensor,  # last entry's value at z - G_n
        is_first_value: torch.Tensor,
        claimed_sum: torch.Tensor,
        accumulator: ConstraintAccumulator,
        main_next_values: Dict[str, torch.Tensor] = None,  # values at z + G_n
    ):
        super().__init__(claimed_sum.device)
        self._main = main_values
        self._pp = pp_values
        self._inter = interaction_values
        self._inter_prev = interaction_prev_value
        self._is_first = is_first_value
        self._claimed = claimed_sum
        self._acc = accumulator
        self._main_next = main_next_values or {}

    def main(self, name: str) -> Felt:
        return Felt(self._main[name])

    def main_next(self, name: str) -> Felt:
        return Felt(self._main_next[name])

    def preprocessed(self, pp_id: str) -> Felt:
        return Felt(self._pp[pp_id])

    def constraint(self, expr: Felt):
        self._acc.add(expr)

    def finalize_logup(self):
        _finalize_logup(
            self.relation_entries,
            [Felt(v) for v in self._inter],
            Felt(self._inter_prev),
            Felt(self._is_first),
            Felt(self._claimed),
            self._acc,
            self.device,
        )


def _finalize_logup(entries, cols, s_prev, is_first, claimed, acc, device):
    last = len(entries) - 1
    for b, e in enumerate(entries):
        prev_entry = cols[b - 1] if b > 0 else Felt(f.qm31_zero((), device))
        if b < last:
            c = (cols[b] - prev_entry) * e.denominator - e.numerator
        else:
            c = (cols[b] - s_prev - prev_entry + is_first * claimed) * e.denominator - e.numerator
        acc.add(c)
