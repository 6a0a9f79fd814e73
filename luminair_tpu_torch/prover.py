"""prove(pie, settings) -> LuminairProof: the STARK pipeline on the card.

  Phase 0:  commit the preprocessed trace (LUT columns, is_first flags);
  Phase 1:  pad and commit the main trace columns per component;
  Phase 2:  draw interaction elements, build the LogUp interaction columns
            (K5, kernels.air_witness_many), mix the claimed sums, commit;
  Phase 3a: composition polynomial from the constraint quotients of
            every commit domain (K6, kernels.air_domain_many), commit;
  Phase 3b: OODS sampling, DEEP quotients, FRI, PoW, decommitment
            (pcs/scheme.py).

Column work runs on one torch device: CUDA unless the caller passes
device="cpu"; under parallel/sharding.prove_mesh every phase runs over
the mesh, on the row shards that hold each tree's row blocks (K5 with a
carry, K6 with a halo, K4, FRI), and the transcript's kernels on its
lead.  The transcript and the proof's scalars stay on the host.
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
from . import kernels
from . import tracing
from .air import tape
from .air.claim import LuminairClaim, LuminairInteractionClaim
from .air.layout import AirLayout
from .air.pie import LuminairPie
from .crypto.channel import Blake2sChannel
from .errors import EmptyTraceError, ProverError
from .parallel import sharding
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
    """The device of an entry point: the current CUDA device when `device`
    is None."""
    dev = torch.device(device) if device is not None else torch.device("cuda")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise ProverError("no CUDA device; pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ProverError(f"unsupported device {dev}")
    return dev


def prove(pie: LuminairPie, settings, config: Optional[PcsConfig] = None, device=None) -> LuminairProof:
    from .selfcheck import prover_self_check

    mesh = sharding.current_mesh()
    if mesh is None:
        dev = resolve_device(device)
    else:
        dev = mesh.lead
        if device is not None and resolve_device(device) != dev:
            raise ProverError(f"prove() under a mesh runs on its lead device {dev}, not {device}")
    with tracing.root("prove", tracing.request_of(settings), dev, phases_sync=True):
        proof = _prove_once(pie, settings, config or PcsConfig(), dev)
        with tracing.span("self_check"):
            ok = prover_self_check(proof, settings)
        if not ok:
            raise ProverError("proof fails its own OODS composition check")
    return proof


def _prove_once(pie: LuminairPie, settings, config: PcsConfig, dev: torch.device) -> LuminairProof:
    if not 1 <= config.log_blowup <= 4:
        raise ProverError("log_blowup_factor must be in 1..4")
    channel = Blake2sChannel()
    span = tracing.span

    # ---- claim ----------------------------------------------------------
    tables = {n: t for n, t in pie.trace_tables.items() if t.n_rows > 0}
    if not tables:
        raise EmptyTraceError("no trace tables")
    claim = LuminairClaim({n: t.log_size for n, t in tables.items()})
    claim.mix_into(channel)
    layout = AirLayout(claim, settings)
    pcs = CommitmentSchemeProver(config, channel)

    # ---- phase 0: preprocessed -----------------------------------------
    with span("phase0_preprocessed"):
        with span("build"):
            host_cols = list(layout.pp.columns())
        with span("upload"):
            pp_cols = [f.u32_to_tensor(c, dev) for c in host_cols]
            del host_cols
        with span("commit"):
            pcs.commit(pp_cols)
        pp_by_id = dict(zip(layout.pp.ids(), pp_cols))

    # ---- phase 1: main trace -------------------------------------------
    with span("phase1_main"):
        main_cols: List[torch.Tensor] = []
        padded_by_comp: Dict[str, Dict[str, torch.Tensor]] = {}
        with span("columns"):
            for c in layout.components:
                padded = tables[c.name].padded_columns(c.MAIN)
                padded_by_comp[c.name] = {n: _main_column(v, dev) for n, v in padded.items()}
                main_cols.extend(padded_by_comp[c.name][n] for n in c.MAIN)
        with span("commit"):
            pcs.commit(main_cols)
        del main_cols

    # ---- phase 2: interaction ------------------------------------------
    with span("phase2_interaction"):
        elems = layout.draw_elements(channel)
        ew = tape.element_words(elems)
        inter_cols: List[torch.Tensor] = []
        claimed: Dict[str, torch.Tensor] = {}
        mesh = pcs.trees[0].mesh

        def witness_inputs():
            for c in layout.components:
                cols = padded_by_comp.pop(c.name)
                yield tape.record(c, witness=True), [cols[n] for n in c.MAIN], [pp_by_id[p] for p in c.PP_IDS]

        for c, (out, claimed[c.name]) in zip(layout.components, sharding.air_witness_many(mesh, witness_inputs(), ew)):
            inter_cols.extend(sharding.unbind(out))
        # One download for every claimed sum.
        sums_u32 = f.tensor_to_u32(torch.stack(list(claimed.values())))
        interaction_claim = LuminairInteractionClaim(dict(zip(claimed, sums_u32)))
        interaction_claim.mix_into(channel)
        pcs.commit(inter_cols)
        del inter_cols, pp_by_id

    # ---- phase 3a: composition poly ------------------------------------
    with span("phase3a_composition"):
        alpha = f.qm31_words(channel.draw_felt())
        pcs.commit(_composition(layout, claim, pcs, config.log_blowup, interaction_claim.sums, alpha, ew, dev))

    # ---- phase 3b: OODS + FRI ------------------------------------------
    with span("phase3b_oods_fri"):
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


def _main_column(col, dev: torch.device) -> torch.Tensor:
    """A padded trace column on `dev`: a tensor born there (the device
    trace) as it is, host words uploaded."""
    if isinstance(col, torch.Tensor):
        if col.device != dev:
            raise ProverError(f"the trace lies on {col.device}, the prover runs on {dev}")
        return col
    return f.u32_to_tensor(col, dev)


def _composition(layout, claim, pcs, B, claimed, alpha, ew, dev) -> list:
    """The 4 coordinate columns of the composition polynomial's evaluations
    on D_(max_log+1).

    Constraints are evaluated pointwise on each component's commit domain
    (trace log + B), where "next row" is a roll by 2^B, and divided by the
    trace domain's vanishing polynomial: K6, one launch for every commit
    domain, each domain's components summed in registers
    (kernels.air_domain_many).  The working domain's sum (max_log + B) is
    the composition's evaluations; each smaller domain's sum is
    interpolated and lands strided in a coefficient vector evaluated once
    at the end.  At B >= 2 the working domain is larger than the
    composition's degree bound, so the sum is down-committed to
    D_{max_log+1}.  The alpha powers run on across components in canonical
    order.

    Under a mesh whose shards each hold a row of the largest trace, the
    working domain is row-sharded (`_composition_rows`); otherwise it lies
    on the lead, the trees' row blocks gathered there."""
    mesh = pcs.trees[0].mesh
    groups = _quotient_groups(layout, claim, pcs, B, alpha, claimed)
    if mesh.size > 1 and 1 << claim.max_log_size >= mesh.size:
        return _composition_rows(claim, B, groups, ew, mesh)
    comp_log = claim.max_log_size + B
    blocks = [kernels.DomainBlock([kernels.DomainTerm(*_gathered(t)) for t in terms], n, 1 << B)
              for terms, n, _ in groups]
    comp_evals = comp_coeffs = None  # comp_coeffs: (4, 2^comp_log) int32
    for (_, _, stride), q in zip(groups, kernels.air_domain_many(blocks, ew)):
        if stride == 1:
            comp_evals = q
            continue
        coeffs = fft.ifft(q.t().contiguous())
        if comp_coeffs is None:
            comp_coeffs = torch.zeros((4, 1 << comp_log), dtype=f.I32, device=dev)
        comp_coeffs[:, ::stride] = f.add(comp_coeffs[:, ::stride].to(f.I64), coeffs.to(f.I64)).to(f.I32)
    if comp_coeffs is not None:
        extra = fft.fft(comp_coeffs).t()
        comp_evals = f.add(comp_evals.to(f.I64), extra.to(f.I64)).to(f.I32)
    if B > 1:
        # The composition has degree < 2^(max_log + 1): its coefficients on
        # the working domain sit on the stride-2^(B-1) positions.
        ct = fft.ifft(comp_evals.t().contiguous())
        comp_evals = fft.fft(ct[:, :: 1 << (B - 1)].contiguous()).t()
    return [comp_evals[:, k] for k in range(4)]


def _gathered(term: tuple) -> tuple:
    """A quotient term (`_quotient_groups`) with its columns on the lead."""
    tp, main, pp, inter, is_first, claimed, pows = term
    return (tp, [sharding.on_lead(c) for c in main], [sharding.on_lead(c) for c in pp],
            [sharding.on_lead(c) for c in inter], sharding.on_lead(is_first), claimed, pows)


def _quotient_groups(layout, claim, pcs, B, alpha, claimed) -> list:
    """The commit domains of a prove: per trace log, in the order of its
    first component, (its components' terms, the log, its stride in the
    working domain D_(max_log + B)); a term is (tape, main, pp, inter,
    is_first, claimed sum, alpha powers) with the columns as the trees
    hold them, the alpha powers running on across components in canonical
    order."""
    comp_log = claim.max_log_size + B
    acc_pow = (1, 0, 0, 0)
    tree_pp, tree_main, tree_inter = pcs.trees[0], pcs.trees[1], pcs.trees[2]
    groups: Dict[int, list] = {}
    for c in layout.components:
        tp = tape.record(c)
        n = claim.log_sizes[c.name]
        s0, _ = layout.main_slices[c.name]
        b0, b1 = layout.inter_slices[c.name]
        pows, acc_pow = f.qm31_powers_ints(acc_pow, alpha, tp.n_pows)
        groups.setdefault(n, []).append((
            tp, tree_main.evals[s0 : s0 + len(c.MAIN)], [tree_pp.evals[layout.pp_index(pid)] for pid in c.PP_IDS],
            tree_inter.evals[4 * b0 : 4 * b1], tree_pp.evals[layout.pp_index(layout.is_first_id(c.name))],
            claimed[c.name], pows))
    return [(terms, n, 1 << (comp_log - n - B)) for n, terms in groups.items()]


def _composition_rows(claim, B, groups, ew, mesh) -> list:
    """`_composition` with the working domain in row blocks: K6 one launch
    a row shard over its blocks of every domain with their halos
    (sharding.air_domain_many; a domain of fewer trace rows than shards
    whole in the lead's launch, over its gathered columns), the smaller
    domains' interpolation and the down-commit on the column shards (K1,
    the blocks exchanged).  RowBlocks columns."""
    comp_log = claim.max_log_size + B
    domains = [(terms if 1 << n >= mesh.size else [_gathered(t) for t in terms], n, 1 << B) for terms, n, _ in groups]
    comp = comp_coeffs = None  # comp_coeffs: the column shards' blocks of the (4, 2^comp_log) coefficients
    for (_, _, stride), q in zip(groups, sharding.air_domain_many(mesh, domains, ew)):
        if stride == 1:
            comp = q
        else:
            comp_coeffs = sharding.add_strided_coeffs(mesh, comp_coeffs, q, stride, comp_log)
    if comp_coeffs is not None:
        comp = sharding.add_coeff_evals(comp, comp_coeffs, comp_log)
    comp = sharding.down_commit(comp, 1 << (B - 1), comp_log) if B > 1 else sharding.RowBlocks(
        mesh, [b.t() for b in comp])
    return sharding.unbind(comp)
