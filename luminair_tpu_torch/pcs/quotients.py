"""DEEP quotients: reduce "column c opened at point z with value v" claims
to a FRI low-degree claim.

For committed columns with M31 coefficients, the quotient for a sample
(z, v) divides by the line through z and conj(z) (the Gal(QM31/CM31)
involution) after subtracting the linear interpolant through (z, v),
(conj z, conj v).  Samples opened at the same point share a denominator;
every (column, point) sample gets its own power of the batching challenge
gamma, in the enumeration order the verifier shares.

The per-group constants are host work on CPU (S, 4) tensors; every
(commit log, point) group of a prove then runs on its domain in one call
of the DEEP-quotient kernel (kernels.deep_quotient_many, K4).  Because a
sample point lies off the base field, A, B and C below lie in u * CM31: the
line is L = u * d with d a CM31 value affine in the row's (x, y), which K4
inverts in the base field's tower (csrc/quotient.cuh).

The verifier evaluates the same quotients at the opened positions only, on
the host (`quotients_at_positions`): the groups' constants from
`quotient_groups`, the denominators inverted in one batch."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch

from .. import fields as f
from .. import kernels, tracing
from ..errors import ProverError
from ..parallel import sharding


@dataclass
class ColumnSample:
    commit_log: int
    tree: int
    col: int
    point: tuple  # (x, y), each a (4,) int64 QM31 tensor
    value: np.ndarray  # (4,) uint32 QM31


def _gamma_powers(gamma: tuple, n: int, k: int = 16) -> torch.Tensor:
    """(n, 4) int64 gamma^0 .. gamma^(n-1) as gamma^(k a + b) = (gamma^k)^a *
    gamma^b: two short tables of Python ints, one batched product."""
    lo, hi = f.qm31_powers_ints((1, 0, 0, 0), gamma, k)
    hi_pows, _ = f.qm31_powers_ints((1, 0, 0, 0), hi, -(-n // k))
    return f.qm31_mul(torch.tensor(hi_pows)[:, None], torch.tensor(lo)[None]).reshape(-1, 4)[:n]


def quotient_groups(
    samples: List[ColumnSample],
    column_evals: Dict[Tuple[int, int], torch.Tensor],
    gamma: torch.Tensor,
) -> List[tuple]:
    """Every (commit log, point) group of the samples, in first-appearance
    order: (log, columns, (S, 4) gamma powers, (5, 4) consts = A, B, C,
    acc_a, acc_c0), int64 numpy QM31, with
      denominator L(P) = A*x_P - B*y_P + C       (the group's point z)
      numerator(P)   = sum_i g_i c_i(P) - acc_a*x_P - acc_c0,
    acc_a = sum_i g_i a_i, acc_c0 = sum_i g_i (v_i - a_i zx) and a_i =
    (conj v_i - v_i) / (conj zx - zx) for the sample values v_i.  The sums
    over a group's samples are taken for every group at once, on CPU
    tensors."""
    keys: Dict[tuple, int] = {}
    points, gid, words = [], [], {}
    for s in samples:
        pw = words.get(id(s.point))
        if pw is None:
            pw = words[id(s.point)] = (tuple(s.point[0].tolist()), tuple(s.point[1].tolist()))
        g = keys.setdefault((s.commit_log, pw), len(keys))
        if g == len(points):
            points.append(pw)
        gid.append(g)
    zx = torch.tensor([p[0] for p in points]) % f.P
    zy = torch.tensor([p[1] for p in points]) % f.P
    A = f.sub(f.qm31_conj(zy), zy)
    B = f.sub(f.qm31_conj(zx), zx)  # conj zx - zx, also a_i's denominator
    C = f.sub(*f.qm31_mul(torch.stack([B, A]), torch.stack([zy, zx])))  # B zy - A zx
    if bool((B == 0).all(dim=-1).any()):
        raise ProverError("sample point x lies in CM31")
    gid = torch.tensor(gid)
    order = torch.argsort(gid, stable=True)  # the samples group by group
    gp = _gamma_powers(f.qm31_words(gamma), len(samples))[order]
    v = torch.from_numpy(np.array([samples[i].value for i in order.tolist()], dtype=np.int64))
    sums = torch.zeros((2, len(points), 4), dtype=f.I64)  # sum g_i v_i, sum g_i conj v_i per group
    sums.index_add_(1, gid[order], f.qm31_mul(gp, torch.stack([v, f.qm31_conj(v)])))
    sv, scv = sums % f.P
    acc_a = f.qm31_mul(f.sub(scv, sv), f.qm31_inv(B))
    acc_c0 = f.sub(sv, f.qm31_mul(acc_a, zx))
    consts = torch.stack([A, B, C, acc_a, acc_c0], dim=1).numpy()
    gp, order = gp.numpy(), order.tolist()
    ends = np.cumsum(np.bincount(gid.numpy())).tolist()
    return [(samples[order[a]].commit_log, [column_evals[(samples[i].tree, samples[i].col)] for i in order[a:b]],
             gp[a:b], c) for a, b, c in zip([0] + ends[:-1], ends, consts)]


def accumulate_quotients(
    samples: List[ColumnSample],
    column_evals: Dict[Tuple[int, int], torch.Tensor],
    gamma: torch.Tensor,
) -> Dict[int, torch.Tensor]:
    """Quotient evaluations per commit log on the full commitment domains.

    column_evals: {(tree, col): (2^commit_log,) int32 evaluations, or
    their RowBlocks over a mesh's row shards}; gamma a (4,) int64 QM31.
    Returns {commit_log: (2^log, 4) int32, or RowBlocks of (2^log / n,
    4)}: the logs whose columns lie on the lead in one call of K4 there,
    the row-sharded logs in one call on each row shard, over its blocks
    (`QuotientPlan`'s shard); a plan's gammas and constants are the same
    on every shard, in its one upload."""
    with tracing.span("3b_quotients.constants"):
        groups = quotient_groups(samples, column_evals, gamma)
    with tracing.span("3b_quotients.plan"):
        lead = [g for g in groups if not isinstance(g[1][0], sharding.RowBlocks)]
        rows = [g for g in groups if isinstance(g[1][0], sharding.RowBlocks)]
        plans = [(None, kernels.QuotientPlan(lead))] if lead else []
        if rows:
            mesh = rows[0][1][0].mesh
            s = mesh.size.bit_length() - 1
            plans += [(pos, kernels.QuotientPlan([(log, [c[r] for c in cols], g, k) for log, cols, g, k in rows],
                                                 shard=(r, s))) for r, (pos, _) in enumerate(mesh.row_shards())]
    with tracing.span("3b_quotients.launch"):
        out, by_shard = {}, []
        for pos, plan in plans:
            if pos is None:
                out.update(kernels.deep_quotient_many(plan))
                continue
            with kernels.on_shard(pos):
                by_shard.append(kernels.deep_quotient_many(plan))
        for log in by_shard[0] if by_shard else ():
            out[log] = sharding.RowBlocks(mesh, [q[log] for q in by_shard], 0)
        return out


def quotients_at_positions(
    samples: List[ColumnSample],
    opened: Dict[Tuple[int, int], torch.Tensor],
    gamma,
    domains: Dict[int, tuple],
) -> Dict[int, torch.Tensor]:
    """The verifier's quotients, on the host: {commit_log: (m, 4) int64}
    at the m positions of `domains[log]` = (xs, ys) (int64 tensors), from
    `opened` = {(tree, col): (m,) int64 values of the column there}.  Each
    group's denominator A x - B y + C, numerator sum_i g_i c_i - acc_a x -
    acc_c0; every group's denominators inverted in one batch."""
    groups = quotient_groups(samples, opened, f.host_i64(gamma))
    dens, nums = [], []
    for log, cols, gp, consts in groups:
        xs, ys = domains[log]
        A, B, C, acc_a, acc_c0 = torch.from_numpy(consts)
        dens.append(f.add(f.sub(f.qm31_mul_m31(A, xs), f.qm31_mul_m31(B, ys)), C))
        g_c = (torch.from_numpy(gp)[:, None, :] * torch.stack(cols)[:, :, None]) % f.P
        nums.append(f.sub(f.sub(g_c.sum(0) % f.P, f.qm31_mul_m31(acc_a, xs)), acc_c0))
    inv = f.qm31_inv(torch.cat(dens)).split([len(d) for d in dens])
    out: Dict[int, torch.Tensor] = {}
    for (log, *_), num, d_inv in zip(groups, nums, inv):
        q = f.qm31_mul(num, d_inv)
        out[log] = f.add(out[log], q) if log in out else q
    return out
