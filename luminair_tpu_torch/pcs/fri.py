"""Circle FRI, prover side: commit, fold, decommit.

Inputs are QM31 DEEP-quotient evaluations on canonic circle domains of
mixed sizes (one per committed column log size).  The protocol (the
reference package's pcs/fri.py):

  1. draw alpha0; circle-fold every input onto its line domain;
  2. walk line layers from the largest down: commit the current layer
     (4 M31 coordinate columns in one Merkle tree), mix the root, draw
     alpha, then fold `folds_per_layer` times -- fold t uses
     beta_t = alpha^(2^t).  When a smaller input's line domain size is
     reached, it joins scaled by beta_t^2;
  3. stop at 2^(log_blowup + last_layer_degree); interpolate, check the
     strided low-degree structure, send the last-layer coefficients;
  4. after PoW and query drawing, decommit every committed layer at the
     positions needed to replay its folds.

Layers stay on the device: each fold is one launch of the FRI-fold kernel
(kernels.fri_fold, K3) and each layer tree goes through the Merkle kernel.
The channel stays on the host, so each committed layer costs one root
download (a sync) before its alpha is drawn.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np
import torch

from .. import circle
from .. import fields as f
from .. import fft
from .. import kernels
from ..crypto.merkle import MerkleTree, run_plans
from ..errors import ProverError
from .config import FriConfig


def _qm31(felt: np.ndarray) -> torch.Tensor:
    return torch.as_tensor(np.asarray(felt, dtype=np.int64))


def fold_circle_to_line(values: torch.Tensor, circle_log: int, alpha) -> torch.Tensor:
    """(2^circle_log, 4) on D_circle_log -> (N/2, 4) on its line domain:
    f(P) = E(x) + y*O(x), out = E + alpha*O."""
    tw = circle.twiddle_stage(circle_log, 0, True, values.device)
    return kernels.fri_fold(values, tw, alpha)


def fold_line(values: torch.Tensor, kmax: int, line_log: int, alpha, mix=None, beta2=None):
    """(2^line_log, 4) -> (2^(line_log-1), 4) with pairing (i, L-1-i) and the
    1/(2x) twiddles of D_kmax's stage kmax - line_log (+ beta2 * mix)."""
    tw = circle.twiddle_stage(kmax, kmax - line_log, True, values.device)
    return kernels.fri_fold(values, tw, alpha, mix, beta2)


@dataclass
class FriProof:
    layer_roots: List[np.ndarray]
    layer_queried_values: List[List[np.ndarray]]  # per layer: 4 value arrays
    layer_witnesses: List[List[np.ndarray]]
    last_layer_coeffs: np.ndarray  # (2^D, 4) strided-extracted coefficients
    pow_nonce: int = 0


def fri_prove(inputs: Dict[int, torch.Tensor], config: FriConfig, channel):
    """inputs: {circle_log: (2^log, 4) int32 QM31 evaluations}.  Returns
    (FriProof without openings, context for `fri_decommit`)."""
    logs = sorted(inputs, reverse=True)
    assert logs, "no FRI inputs"
    kmax = logs[0]
    B = config.log_blowup_factor
    last_line_log = B + config.log_last_layer_degree_bound
    if min(logs) - 1 < last_line_log:
        raise ProverError("FRI last layer above the smallest input's line domain")
    F = max(1, int(config.folds_per_layer))

    alpha0 = channel.draw_felt()
    line_evals = {k - 1: fold_circle_to_line(inputs[k], k, alpha0) for k in logs}
    cur = line_evals[kmax - 1]
    cur_log = kmax - 1
    layers = []  # (log, evals, MerkleTree)
    alphas = []
    while cur_log > last_line_log:
        tree = MerkleTree({cur_log: cur.t()})
        channel.mix_root(tree.root)
        alpha = channel.draw_felt()
        alphas.append(alpha)
        layers.append((cur_log, cur, tree))
        beta = _qm31(alpha)
        for _ in range(min(F, cur_log - last_line_log)):
            mix = cur_log - 1 in line_evals and cur_log - 1 != kmax - 1
            beta2 = f.qm31_mul(beta, beta)
            cur = fold_line(
                cur, kmax, cur_log, beta,
                mix=line_evals[cur_log - 1] if mix else None,
                beta2=beta2 if mix else None,
            )
            cur_log -= 1
            beta = beta2

    # Last layer: tiny -- interpolate on the host, extract strided coeffs.
    tw_line_inv = circle.ifft_twiddles(kmax)[kmax - cur_log :]
    coeffs = fft.line_ifft_qm31(cur.cpu().to(f.I64), tw_line_inv)
    stride = 1 << B
    mask = torch.ones(len(coeffs), dtype=torch.bool)
    mask[::stride] = False
    if bool(torch.any(coeffs[mask] != 0)):
        raise ProverError("FRI last layer exceeds its degree bound")
    last_coeffs = f.tensor_to_u32(coeffs[::stride].contiguous())
    channel.mix_felts(last_coeffs)

    proof = FriProof(
        layer_roots=[t.root for (_, _, t) in layers],
        layer_queried_values=[],
        layer_witnesses=[],
        last_layer_coeffs=last_coeffs,
    )
    ctx = {
        "layers": layers,
        "kmax": kmax,
        "folds_per_layer": F,
        "last_line_log": last_line_log,
    }
    return proof, ctx


def fold_position_sets(pending, level_log: int, depth: int):
    """Position sets the verifier materialises when folding `depth` steps
    from carried positions `pending` at line level `level_log`:
    [S_0, ..., S_depth], S_0 the full coset the committed layer opens."""
    final = {int(p) for p in pending}
    for t in range(depth):
        n = 1 << (level_log - t)
        final = {min(p, n - 1 - p) for p in final}
    sets = [final]
    for t in range(depth, 0, -1):
        n = 1 << (level_log - t + 1)
        sets.append({q for p in sets[-1] for q in (p, n - 1 - p)})
    sets.reverse()
    return sets


def fri_decommit(proof: FriProof, ctx, positions: np.ndarray):
    """Fill the proof's per-layer openings for the sorted unique bottom
    positions; every layer's gathers download in one transfer."""
    kmax = ctx["kmax"]
    F = ctx["folds_per_layer"]
    last_line_log = ctx["last_line_log"]
    n = 1 << kmax
    pos = {min(int(p), n - 1 - int(p)) for p in positions}  # line kmax-1
    plans = []
    for (log, _evals, tree) in ctx["layers"]:
        sets = fold_position_sets(pos, log, min(F, log - last_line_log))
        queries = {log: sorted(sets[0])}
        plans.append((tree.queried_values_plan(queries), tree.decommit_plan(queries)))
        pos = sets[-1]
    for values, witness in run_plans(plans):
        proof.layer_queried_values.append(values)
        proof.layer_witnesses.append(witness)
    return proof


def needed_input_positions(drawn_positions, input_logs, fri_config) -> Dict[int, list]:
    """For each input circle log, the positions at which the verifier needs
    the FRI input (DEEP quotient) values -- the positions at which the
    committed columns of that commit log are opened."""
    logs = sorted({int(l) for l in input_logs}, reverse=True)
    kmax = logs[0]
    n = 1 << kmax
    need = {kmax: sorted({q for p in drawn_positions for q in (int(p), n - 1 - int(p))})}
    pos = {min(int(p), n - 1 - int(p)) for p in drawn_positions}
    F = max(1, int(fri_config.folds_per_layer))
    last_line_log = fri_config.log_blowup_factor + fri_config.log_last_layer_degree_bound
    cur_log = kmax - 1
    while cur_log > last_line_log:
        fl = min(F, cur_log - last_line_log)
        sets = fold_position_sets(pos, cur_log, fl)
        for t in range(1, fl + 1):
            k = cur_log - t + 1  # a circle-log-k input mixes at line level k-1
            if k in logs and k != kmax:
                need[k] = sorted({q for i in sets[t] for q in (i, (1 << k) - 1 - i)})
        pos = sets[-1]
        cur_log -= fl
    return need
