"""DEEP quotients: reduce "column c opened at point z with value v" claims
to a FRI low-degree claim (prover side).

For committed columns with M31 coefficients, the quotient for a sample
(z, v) divides by the line through z and conj(z) (the Gal(QM31/CM31)
involution) after subtracting the linear interpolant through (z, v),
(conj z, conj v).  Samples opened at the same point share a denominator;
every (column, point) sample gets its own power of the batching challenge
gamma, in the enumeration order the verifier shares.

The per-sample constants are host work on (S, 4) tensors; each
(commit log, point) group runs on its domain through the DEEP-quotient
kernel (kernels.deep_quotient, K4).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch

from .. import fields as f
from .. import kernels
from ..errors import ProverError


@dataclass
class ColumnSample:
    commit_log: int
    tree: int
    col: int
    point: tuple  # (x, y), each a (4,) int64 QM31 tensor
    value: np.ndarray  # (4,) uint32 QM31


def _batch_constants(samples: List[ColumnSample]):
    """(A, B, C, a_coef, c0), each (S, 4), with
      denominator L(P) = A*x_P - B*y_P + C
      numerator_i(P)  = c_i(P) - a_coef*x_P - c0."""
    zx = torch.stack([s.point[0].cpu() for s in samples])
    zy = torch.stack([s.point[1].cpu() for s in samples])
    v = torch.as_tensor(np.stack([np.asarray(s.value, dtype=np.int64) for s in samples]))
    zbx, zby = f.qm31_conj(zx), f.qm31_conj(zy)
    A = f.sub(zby, zy)
    B = f.sub(zbx, zx)
    C = f.sub(f.qm31_mul(B, zy), f.qm31_mul(A, zx))
    dv = f.sub(f.qm31_conj(v), v)
    denom = f.sub(zbx, zx)
    if bool(torch.any(torch.all(denom == 0, dim=-1))):
        raise ProverError("sample point x lies in CM31")
    a_coef = f.qm31_mul(dv, f.qm31_inv(denom))
    c0 = f.sub(v, f.qm31_mul(a_coef, zx))
    return A, B, C, a_coef, c0


def _gamma_powers(gamma: torch.Tensor, n: int) -> torch.Tensor:
    """(n, 4) gamma^0..gamma^(n-1) by repeated doubling."""
    out = f.qm31_one((1,))
    while out.shape[0] < n:
        out = torch.cat([out, f.qm31_mul(out, f.qm31_mul(out[-1], gamma))])
    return out[:n]


def accumulate_quotients(
    samples: List[ColumnSample],
    column_evals: Dict[Tuple[int, int], torch.Tensor],
    gamma: torch.Tensor,
) -> Dict[int, torch.Tensor]:
    """Quotient evaluations per commit log on the full commitment domains.

    column_evals: {(tree, col): (2^commit_log,) int32 evaluations}; gamma a
    (4,) int64 QM31.  Returns {commit_log: (2^log, 4) int32}."""
    groups: Dict[tuple, list] = {}
    for idx, s in enumerate(samples):
        key = (s.commit_log, tuple(s.point[0].tolist()), tuple(s.point[1].tolist()))
        groups.setdefault(key, []).append((idx, s))

    allA, allB, allC, all_a, all_c0 = _batch_constants(samples)
    gpows = _gamma_powers(gamma.cpu(), len(samples))
    out: Dict[int, torch.Tensor] = {}
    for batch in groups.values():  # insertion order: first appearance
        log = batch[0][1].commit_log
        idxs = torch.tensor([idx for idx, _ in batch])
        gs = gpows[idxs]
        first = int(idxs[0])
        acc_a = f.qm31_mul(gs, all_a[idxs]).sum(dim=0) % f.P
        acc_c0 = f.qm31_mul(gs, all_c0[idxs]).sum(dim=0) % f.P
        consts = torch.stack([allA[first], allB[first], allC[first], acc_a, acc_c0])
        cols = [column_evals[(s.tree, s.col)] for _, s in batch]
        out[log] = kernels.deep_quotient(cols, gs, consts, log, out.get(log))
    return out
