"""prove(pie, settings) -> LuminairProof: the STARK pipeline on the card.

  Phase 0:  commit the preprocessed trace (LUT columns, is_first flags);
  Phase 1:  pad and commit the main trace columns per component;
  Phase 2:  draw interaction elements, build the LogUp interaction columns,
            mix the claimed sums, commit;
  Phase 3a: composition polynomial from the per-component constraint
            quotients, commit;
  Phase 3b: OODS sampling, DEEP quotients, FRI, PoW, decommitment
            (pcs/scheme.py).

Column work runs on one torch device: CUDA unless the caller passes
device="cpu".  The transcript and the proof's scalars stay on the host.
Before returning, prove() replays the transcript and checks the composition
identity at the OODS point (selfcheck.py); a mismatch raises ProverError.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, List, Optional

import numpy as np
import torch

from . import circle
from . import fields as f
from . import fft
from . import tracing
from .air.claim import LuminairClaim, LuminairInteractionClaim
from .air.framework import ConstraintAccumulator, DomainEval, WitnessEval
from .air.layout import AirLayout
from .air.pie import LuminairPie
from .crypto.channel import Blake2sChannel
from .errors import EmptyTraceError, ProverError
from .pcs.config import PcsConfig
from .pcs.scheme import CommitmentSchemeProver, PcsProof


@dataclass
class LuminairProof:
    claim: LuminairClaim
    interaction_claim: LuminairInteractionClaim
    roots: List[np.ndarray]
    pcs_proof: PcsProof
    config: PcsConfig


def resolve_device(device=None) -> torch.device:
    """The proving device: the current CUDA device when `device` is None."""
    dev = torch.device(device) if device is not None else torch.device("cuda")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise ProverError("no CUDA device; pass device='cpu' to prove on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ProverError(f"unsupported device {dev}")
    return dev


def prove(pie: LuminairPie, settings, config: Optional[PcsConfig] = None, device=None) -> LuminairProof:
    from .selfcheck import prover_self_check

    dev = resolve_device(device)
    proof = _prove_once(pie, settings, config or PcsConfig(), dev)
    with tracing.current("prove").span("self_check"):
        ok = prover_self_check(proof, settings)
    if not ok:
        raise ProverError("proof fails its own OODS composition check")
    return proof


def _prove_once(pie: LuminairPie, settings, config: PcsConfig, dev: torch.device) -> LuminairProof:
    if not 1 <= config.log_blowup <= 4:
        raise ProverError("log_blowup_factor must be in 1..4")
    channel = Blake2sChannel()
    timer = tracing.start("prove", (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else None)

    # ---- claim ----------------------------------------------------------
    tables = {n: t for n, t in pie.trace_tables.items() if t.n_rows > 0}
    if not tables:
        raise EmptyTraceError("no trace tables")
    claim = LuminairClaim({n: t.log_size for n, t in tables.items()})
    claim.mix_into(channel)
    layout = AirLayout(claim, settings)
    pcs = CommitmentSchemeProver(config, channel)

    # ---- phase 0: preprocessed -----------------------------------------
    with timer.span("phase0_preprocessed"):
        pp_cols = [f.u32_to_tensor(c, dev) for c in layout.pp.columns()]
        pcs.commit(pp_cols)
        pp_by_id = dict(zip(layout.pp.ids(), pp_cols))

    # ---- phase 1: main trace -------------------------------------------
    with timer.span("phase1_main"):
        main_cols: List[torch.Tensor] = []
        padded_by_comp: Dict[str, Dict[str, torch.Tensor]] = {}
        for c in layout.components:
            padded = tables[c.name].padded_columns(c.MAIN)
            padded_by_comp[c.name] = {n: f.u32_to_tensor(v, dev) for n, v in padded.items()}
            main_cols.extend(padded_by_comp[c.name][n] for n in c.MAIN)
        pcs.commit(main_cols)
        del main_cols

    # ---- phase 2: interaction ------------------------------------------
    with timer.span("phase2_interaction"):
        elems = layout.draw_elements(channel, dev)
        inter_cols: List[torch.Tensor] = []
        claimed: Dict[str, torch.Tensor] = {}
        for c in layout.components:
            wev = WitnessEval(padded_by_comp.pop(c.name), pp_by_id)
            c.evaluate(wev, elems)
            cols_q, claimed[c.name] = wev.build_interaction()
            inter_cols.extend(q[:, k] for q in cols_q for k in range(4))
        # One download for every claimed sum.
        sums_u32 = f.tensor_to_u32(torch.stack(list(claimed.values())))
        interaction_claim = LuminairInteractionClaim(dict(zip(claimed, sums_u32)))
        interaction_claim.mix_into(channel)
        pcs.commit(inter_cols)
        del inter_cols, pp_by_id

    # ---- phase 3a: composition poly ------------------------------------
    with timer.span("phase3a_composition"):
        alpha = f.u32_to_tensor(channel.draw_felt(), dev, f.I64)
        comp_evals = _composition(layout, claim, pcs, config.log_blowup, claimed, alpha, elems, dev)
        pcs.commit([comp_evals[:, k] for k in range(4)])

    # ---- phase 3b: OODS + FRI ------------------------------------------
    with timer.span("phase3b_oods_fri"):
        # Clamp the FRI last-layer bound to what the smallest committed
        # column admits; the effective value ships in the proof's config.
        min_log = min(min(t.commit_logs) for t in pcs.trees)
        eff = max(0, min(config.fri.log_last_layer_degree_bound, min_log - 1 - config.log_blowup))
        if eff != config.fri.log_last_layer_degree_bound:
            config = replace(config, fri=replace(config.fri, log_last_layer_degree_bound=eff))
            pcs.config = config
        z = circle.point_from_t_qm31(f.u32_to_tensor(channel.draw_felt(), "cpu", f.I64))
        pcs_proof = pcs.prove_values(layout.sample_points(z))

    return LuminairProof(
        claim=claim,
        interaction_claim=interaction_claim,
        roots=[t.root for t in pcs.trees],
        pcs_proof=pcs_proof,
        config=config,
    )


def _composition(layout, claim, pcs, B, claimed, alpha, elems, dev) -> torch.Tensor:
    """(2^(max_log+1), 4) int64 evaluations of the composition polynomial.

    Constraints are evaluated pointwise on each component's commit domain
    (trace log + B), where "next row" is a roll by 2^B.  Components whose
    domain is the working domain (max_log + B) sum their quotient
    evaluations directly; smaller ones interpolate and land strided in a
    coefficient vector evaluated once at the end.  At B >= 2 the working
    domain is larger than the composition's degree bound, so the sum is
    down-committed to D_{max_log+1}."""
    comp_log = claim.max_log_size + B
    comp_evals = None  # (2^comp_log, 4) int64
    comp_coeffs = None  # (4, 2^comp_log) int64
    acc_pow = f.qm31_from_ints(1, device=dev)
    tree_pp, tree_main, tree_inter = pcs.trees[0], pcs.trees[1], pcs.trees[2]
    for c in layout.components:
        n = claim.log_sizes[c.name]
        eval_log = n + B
        s0, _ = layout.main_slices[c.name]
        b0, b1 = layout.inter_slices[c.name]
        acc = ConstraintAccumulator(alpha, (1 << eval_log,), acc_pow)
        ev = DomainEval(
            {name: tree_main.evals[s0 + i] for i, name in enumerate(c.MAIN)},
            {pid: tree_pp.evals[layout.pp_index(pid)] for pid in c.PP_IDS},
            [
                torch.stack([tree_inter.evals[(b0 + b) * 4 + k] for k in range(4)], dim=-1).to(f.I64)
                for b in range(b1 - b0)
            ],
            tree_pp.evals[layout.pp_index(layout.is_first_id(c.name))],
            claimed[c.name],
            acc,
            roll_stride=1 << B,
        )
        c.evaluate(ev, elems)
        acc_pow = acc.pow
        # Divide by the vanishing polynomial of the trace domain.
        xs = circle.domain_table(eval_log, dev)[0].to(f.I64)
        q = f.qm31_mul_m31(acc.acc, f.inv(circle.coset_vanishing_eval(xs, n)))
        stride = 1 << (comp_log - eval_log)
        if stride == 1:
            comp_evals = q if comp_evals is None else f.add(comp_evals, q)
            continue
        coeffs = fft.ifft(q.t().to(f.I32).contiguous()).to(f.I64)
        if comp_coeffs is None:
            comp_coeffs = torch.zeros((4, 1 << comp_log), dtype=f.I64, device=dev)
        comp_coeffs[:, ::stride] = f.add(comp_coeffs[:, ::stride], coeffs)
    if comp_coeffs is not None:
        extra = fft.fft(comp_coeffs.to(f.I32)).t().to(f.I64)
        comp_evals = extra if comp_evals is None else f.add(comp_evals, extra)
    if B > 1:
        # The composition has degree < 2^(max_log + 1): its coefficients on
        # the working domain sit on the stride-2^(B-1) positions.
        ct = fft.ifft(comp_evals.t().to(f.I32).contiguous())
        comp_evals = fft.fft(ct[:, :: 1 << (B - 1)].contiguous()).t().to(f.I64)
    return comp_evals
