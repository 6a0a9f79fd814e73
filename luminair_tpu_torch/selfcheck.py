"""The prover's end-of-prove integrity gate.

Replays the Fiat-Shamir transcript from the proof's own roots (no tree
recomputation) and checks the composition identity at the OODS point: the
composition polynomial's sampled value must equal the constraint quotients
recombined from the sampled trace values.  Host-side, on (4,) CPU tensors.
The verifier (verifier.py) checks the same identity with
`composition_oods_matches`.
"""

from __future__ import annotations

import numpy as np
import torch

from . import circle
from . import fields as f
from . import tracing
from .air.framework import ConstraintAccumulator, PointEval
from .air.layout import AirLayout, recombine_qm31
from .crypto.channel import Blake2sChannel


def _q(v) -> torch.Tensor:
    return torch.as_tensor(np.asarray(v, dtype=np.int64))


def composition_oods_matches(layout, claim, proof, elems, alpha, z) -> bool:
    sv = proof.pcs_proof.sampled_values
    total = f.qm31_zero(())
    acc_pow = f.qm31_from_ints(1)
    for c in layout.components:
        n = claim.log_sizes[c.name]
        s0, _ = layout.main_slices[c.name]
        b0, b1 = layout.inter_slices[c.name]
        comp_acc = ConstraintAccumulator(alpha, (), acc_pow)
        pev = PointEval(
            {name: _q(sv[1][s0 + i][0]) for i, name in enumerate(c.MAIN)},
            {pid: _q(sv[0][layout.pp_index(pid)][0]) for pid in c.PP_IDS},
            [
                recombine_qm31([_q(sv[2][(b0 + b) * 4 + k][0]) for k in range(4)])
                for b in range(b1 - b0)
            ],
            recombine_qm31([_q(sv[2][(b1 - 1) * 4 + k][1]) for k in range(4)]),
            _q(sv[0][layout.pp_index(layout.is_first_id(c.name))][0]),
            _q(proof.interaction_claim.sums[c.name]),
            comp_acc,
            {name: _q(sv[1][s0 + c.MAIN.index(name)][1]) for name in c.MAIN_NEXT},
        )
        c.evaluate(pev, elems)
        acc_pow = comp_acc.pow
        v = circle.coset_vanishing_eval_qm31(z[0], n)
        total = f.add(total, f.qm31_mul(comp_acc.acc, f.qm31_inv(v)))
    comp_at_z = recombine_qm31([_q(sv[3][k][0]) for k in range(4)])
    return bool(torch.equal(total, comp_at_z))


def prover_self_check(proof, settings) -> bool:
    with tracing.span("replay"):
        layout, elems, alpha, z = _replay(proof, settings)
        if layout is None:
            return False
    with tracing.span("oods_composition"):
        return composition_oods_matches(layout, proof.claim, proof, elems, alpha, z)


def _replay(proof, settings):
    """The prover's transcript replayed from the proof: its layout, lookup
    elements, composition alpha and OODS point (None for each where the
    LogUp sums do not balance)."""
    channel = Blake2sChannel()
    claim = proof.claim
    claim.mix_into(channel)
    layout = AirLayout(claim, settings)
    channel.mix_root(proof.roots[0])
    channel.mix_root(proof.roots[1])
    elems = layout.draw_elements(channel)
    if not proof.interaction_claim.is_balanced():
        return None, None, None, None
    proof.interaction_claim.mix_into(channel)
    channel.mix_root(proof.roots[2])
    alpha = _q(channel.draw_felt())
    channel.mix_root(proof.roots[3])
    z = circle.point_from_t_qm31(_q(channel.draw_felt()))
    return layout, elems, alpha, z
