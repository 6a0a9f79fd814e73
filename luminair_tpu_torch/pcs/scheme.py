"""Commitment scheme, prover side: multi-tree column commitments and their
opening through DEEP quotients and FRI.

  commit phase:   per tree: LDE columns -> Merkle -> mix root
  opening phase:  OODS values -> mix -> draw gamma -> quotients -> FRI ->
                  PoW -> draw queries -> decommit trees and FRI layers

The transcript choreography is the reference package's pcs/scheme.py.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np
import torch

from .. import fields as f
from .. import fft
from .. import tracing
from ..crypto.merkle import MerkleTree, run_plans
from . import fri as fri_mod
from .config import PcsConfig
from .quotients import ColumnSample, accumulate_quotients


@dataclass
class PcsProof:
    sampled_values: list  # [tree][col][point] -> (4,) uint32
    fri_proof: "fri_mod.FriProof"
    pow_nonce: int
    tree_queried_values: list  # [tree] -> list of value arrays
    tree_witnesses: list  # [tree] -> list of digests


class TreeProver:
    """One committed tree: columns on their trace domains, kept as
    coefficients and as LDE evaluations on their commit domains
    (trace log + blowup), one (C, 2^log) matrix per size group."""

    def __init__(self, columns: List[torch.Tensor], log_blowup: int):
        self.log_blowup = log_blowup
        self.trace_logs = []
        for col in columns:
            log = int(col.shape[0]).bit_length() - 1
            assert 1 << log == col.shape[0]
            self.trace_logs.append(log)
        self.coeffs: List[torch.Tensor] = [None] * len(columns)
        self.evals: List[torch.Tensor] = [None] * len(columns)
        by_log: Dict[int, List[int]] = {}
        for i, log in enumerate(self.trace_logs):
            by_log.setdefault(log, []).append(i)
        evals_by_commit_log = {}
        for log, idxs in by_log.items():
            mat = torch.stack([columns[i].to(f.I32) for i in idxs])
            coeffs = fft.ifft(mat)
            evals = fft.extend_coeffs_and_fft(coeffs, log_blowup)
            evals_by_commit_log[log + log_blowup] = evals
            for j, i in enumerate(idxs):
                self.coeffs[i] = coeffs[j]
                self.evals[i] = evals[j]
        self.commit_logs = [l + log_blowup for l in self.trace_logs]
        self.merkle = MerkleTree(evals_by_commit_log)

    @property
    def root(self) -> np.ndarray:
        return self.merkle.root


class CommitmentSchemeProver:
    def __init__(self, config: PcsConfig, channel):
        self.config = config
        self.channel = channel
        self.trees: List[TreeProver] = []

    def commit(self, columns: List[torch.Tensor]) -> int:
        tree = TreeProver(columns, self.config.log_blowup)
        self.channel.mix_root(tree.root)
        self.trees.append(tree)
        return len(self.trees) - 1

    def prove_values(self, sample_points) -> PcsProof:
        """sample_points[tree][col] = list of (x, y) QM31 points.  Returns the
        opening proof; mixes everything into the channel."""
        timer = tracing.current("prove")
        ch = self.channel
        # 1. OODS values from the coefficients, one batch per (point, size)
        #    group across trees, all downloaded in one transfer.
        groups: Dict[tuple, tuple] = {}
        for t, tree in enumerate(self.trees):
            for c, pts in enumerate(sample_points[t]):
                for pi, pt in enumerate(pts):
                    key = (tuple(pt[0].tolist()), tuple(pt[1].tolist()), len(tree.coeffs[c]))
                    groups.setdefault(key, (pt, []))[1].append((t, c, pi))
        with timer.span("3b_oods_eval"):
            pending = []
            for pt, members in groups.values():
                mat = torch.stack([self.trees[t].coeffs[c] for t, c, _ in members])
                pending.append((members, fft.eval_at_point_many(mat, pt)))
            flat = f.tensor_to_u32(torch.cat([e.reshape(-1) for _, e in pending]))
            values = {}
            off = 0
            for members, _ in pending:
                for key in members:
                    values[key] = flat[off : off + 4].copy()
                    off += 4
        # Coefficients only serve the OODS values; free them.
        for tree in self.trees:
            tree.coeffs = None

        sampled_values = []
        samples: List[ColumnSample] = []
        for t, tree in enumerate(self.trees):
            tree_vals = []
            for c, pts in enumerate(sample_points[t]):
                col_vals = []
                for pi, pt in enumerate(pts):
                    v = values[(t, c, pi)]
                    col_vals.append(v)
                    samples.append(ColumnSample(tree.commit_logs[c], t, c, pt, v))
                tree_vals.append(col_vals)
            sampled_values.append(tree_vals)
        for tree_vals in sampled_values:
            for col_vals in tree_vals:
                for v in col_vals:
                    ch.mix_felts(v)

        # 2. Quotients + FRI.
        gamma = torch.as_tensor(ch.draw_felt().astype(np.int64))
        column_evals = {
            (t, c): ev for t, tree in enumerate(self.trees) for c, ev in enumerate(tree.evals)
        }
        with timer.span("3b_quotients"):
            quotients = accumulate_quotients(samples, column_evals, gamma)
        with timer.span("3b_fri_commit"):
            fri_proof, fri_ctx = fri_mod.fri_prove(quotients, self.config.fri, ch)

        # 3. PoW + queries.
        with timer.span("3b_pow"):
            nonce = ch.grind_pow(self.config.pow_bits)
        ch.mix_u64(nonce)
        kmax = max(quotients)
        positions = ch.draw_queries(self.config.fri.n_queries, kmax)

        # 4. Decommit FRI layers and trees.
        with timer.span("3b_decommit"):
            fri_mod.fri_decommit(fri_proof, fri_ctx, positions)
            fri_proof.pow_nonce = nonce
            need = fri_mod.needed_input_positions(positions, sorted(quotients), self.config.fri)
            plans = []
            for tree in self.trees:
                queries = {log: need[log] for log in set(tree.commit_logs) if log in need}
                plans.append(
                    (tree.merkle.queried_values_plan(queries), tree.merkle.decommit_plan(queries))
                )
            opened = run_plans(plans)

        return PcsProof(
            sampled_values=sampled_values,
            fri_proof=fri_proof,
            pow_nonce=nonce,
            tree_queried_values=[v for v, _ in opened],
            tree_witnesses=[w for _, w in opened],
        )
