"""Commitment scheme: multi-tree column commitments and their opening
through DEEP quotients and FRI, prover and verifier.

  commit phase:   per tree: LDE columns -> Merkle -> mix root
  opening phase:  OODS values -> mix -> draw gamma -> quotients -> FRI ->
                  PoW -> draw queries -> decommit trees and FRI layers

Every tree is committed through sharding.ShardedCommit, over the mesh of
parallel/sharding.prove_mesh or else a mesh of the columns' one device.
Under a mesh of several shards that is K1 per column shard, the block
reshard, K2 per row shard and the top on the lead; the tree's evaluations
stay in row blocks on the row shards (`TreeProver.evals`).  The OODS
values come from one K7 call per column shard on the coefficients it
holds; the quotients from one K4 call per row shard over its blocks; FRI
folds each layer on the row shards while its folds leave a row a shard
(K3, the layers' trees sharded, pcs/fri.py); the PoW runs on the lead;
each tree is opened by one K9 pass per row shard and one on the lead.

FRI commits on the card with its channel there (pcs/fri.py, K8); the PoW
nonce is searched on the card (kernels.grind_pow, K10); the opening of
the FRI layers and the trees is one decommitment pass: one upload, one
launch of K9 and one download.

The verifier (`CommitmentSchemeVerifier`) replays the transcript from the
proof and checks the openings at the drawn queries on the host: Merkle
paths through hashlib, quotients at the opened positions, FRI folds at the
queries.  Only the preprocessed tree's recommit (verifier.py) runs on the
card.

The transcript choreography is the reference package's pcs/scheme.py.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np
import torch

from .. import fields as f
from .. import fft
from .. import kernels
from .. import tracing
from .. import circle
from ..crypto.merkle import computed_positions, open_trees, verify_decommitment
from ..errors import ProverError
from ..parallel import sharding
from . import fri as fri_mod
from .config import PcsConfig
from .quotients import ColumnSample, accumulate_quotients, quotients_at_positions


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
    (trace log + blowup), one (C, 2^log) matrix per size group.  The
    commitment runs over the current mesh, or a mesh of the columns' one
    device: the coefficients lie on the column shards (`coeff_shards[c]`:
    the mesh position holding column c's) and `merkle` is row-sharded
    where the mesh has more than one shard.  `evals[c]` is column c's
    evaluations: RowBlocks of its row blocks on the row shards (views of
    the tree's shard blocks) where its commit domain has a row per shard
    and the mesh more than one, else the whole column on the lead.

    columns: tensors (N,), or RowBlocks of (N / n,) blocks already on the
    row shards (a size group is all one or all the other)."""

    def __init__(self, columns: List, log_blowup: int):
        self.log_blowup = log_blowup
        self.trace_logs = []
        for col in columns:
            log = sharding.n_rows(col).bit_length() - 1
            assert 1 << log == sharding.n_rows(col)
            self.trace_logs.append(log)
        self.commit_logs = [l + log_blowup for l in self.trace_logs]
        by_log: Dict[int, List[int]] = {}
        for i, log in enumerate(self.trace_logs):
            by_log.setdefault(log, []).append(i)
        self.mesh = sharding.current_mesh() or sharding.Mesh([columns[0].device], ("chips",))
        commit = sharding.ShardedCommit(
            self.mesh, {log: sharding.stack([columns[i] for i in idxs]) for log, idxs in by_log.items()}, log_blowup)
        self.coeffs: List[torch.Tensor] = [None] * len(columns)
        self.coeff_shards: List[int] = [None] * len(columns)
        self.evals: List = [None] * len(columns)
        for log, idxs in by_log.items():
            cl = log + log_blowup
            for b in commit.blocks[cl]:
                for j in range(b.c0, b.c1):
                    self.coeffs[idxs[j]], self.coeff_shards[idxs[j]] = b.coeffs[j - b.c0], b.pos
            for j, i in enumerate(idxs):
                self.evals[i] = commit.evals[cl][j] if cl in commit.evals else commit.row_blocks(self.mesh, cl, j)
        self.merkle = commit.tree

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

    def _oods_values(self, groups: Dict[tuple, tuple], keys: List[tuple]) -> torch.Tensor:
        """The OODS values: one K7 call per column shard over the
        coefficients it holds (each group's members on that shard, at the
        group's point), the results moved to the lead and put back in the
        order of `keys` (already their order on one shard)."""
        lead = self.trees[0].mesh.lead
        by_shard: Dict[int, list] = {}  # position -> [(group's members there, point)]
        for pt, members in groups.values():
            here: Dict[int, list] = {}
            for m in members:
                here.setdefault(self.trees[m[0]].coeff_shards[m[1]], []).append(m)
            for pos, ms in here.items():
                by_shard.setdefault(pos, []).append((ms, pt))
        parts, order = [], []
        for pos in sorted(by_shard):
            calls = by_shard[pos]
            with kernels.on_shard(pos):
                vals = fft.eval_at_point_many([([self.trees[t].coeffs[c] for t, c, _ in ms], pt) for ms, pt in calls])
            parts.append(f.to_device(vals, lead))
            order.extend(m for ms, _ in calls for m in ms)
        if len(parts) == 1:
            return parts[0]
        at = {m: i for i, m in enumerate(order)}
        return torch.cat(parts)[f.to_device(torch.tensor([at[k] for k in keys]), lead)]

    def prove_values(self, sample_points) -> PcsProof:
        """sample_points[tree][col] = list of (x, y) QM31 points.  Returns the
        opening proof; mixes everything into the channel."""
        span = tracing.span
        ch = self.channel
        # 1. OODS values from the coefficients, one group per (point, size)
        #    across trees, all groups in one call, downloaded in one transfer.
        groups: Dict[tuple, tuple] = {}
        for t, tree in enumerate(self.trees):
            for c, pts in enumerate(sample_points[t]):
                for pi, pt in enumerate(pts):
                    key = (tuple(pt[0].tolist()), tuple(pt[1].tolist()), len(tree.coeffs[c]))
                    groups.setdefault(key, (pt, []))[1].append((t, c, pi))
        with span("3b_oods_eval"):
            keys = [key for _, members in groups.values() for key in members]
            evals = self._oods_values(groups, keys)
            flat = f.tensor_to_u32(evals).reshape(-1, 4)
            values = {key: flat[i].copy() for i, key in enumerate(keys)}
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
        with span("3b_quotients"):
            quotients = accumulate_quotients(samples, column_evals, gamma)
        with span("3b_fri_commit"):
            fri_proof, fri_ctx = fri_mod.fri_prove(quotients, self.config.fri, ch)

        # 3. PoW (K10 on the card) + queries.
        with span("3b_pow"):
            bits = self.config.pow_bits
            nonce = kernels.grind_pow(ch.digest, bits, self.trees[0].mesh.lead)
            if not ch.check_pow_nonce(bits, nonce):
                raise ProverError(f"the proof-of-work nonce {nonce} fails its {bits}-bit check")
        ch.mix_u64(nonce)
        kmax = max(quotients)
        positions = ch.draw_queries(self.config.fri.n_queries, kmax)

        # 4. Decommit FRI layers and trees: one pass.
        with span("3b_decommit"):
            with span("3b_decommit.positions"):
                fri_queries = fri_mod.fri_queries(fri_ctx, positions)
                need = fri_mod.needed_input_positions(positions, sorted(quotients), self.config.fri)
                tree_queries = [{log: need[log] for log in set(tree.commit_logs) if log in need}
                                for tree in self.trees]
            fri_trees = [tree for _, _, tree in fri_ctx["layers"]]
            opened = open_trees(fri_trees + [t.merkle for t in self.trees], fri_queries + tree_queries)
            fri_mod.fill_openings(fri_proof, opened[: len(fri_trees)])
            fri_proof.pow_nonce = nonce
            opened = opened[len(fri_trees) :]

        return PcsProof(
            sampled_values=sampled_values,
            fri_proof=fri_proof,
            pow_nonce=nonce,
            tree_queried_values=[v for v, _ in opened],
            tree_witnesses=[w for _, w in opened],
        )


class CommitmentSchemeVerifier:
    def __init__(self, config: PcsConfig, channel):
        self.config = config
        self.channel = channel
        self.roots: List[np.ndarray] = []
        self.tree_trace_logs: List[List[int]] = []

    def commit(self, root, column_trace_logs: List[int]):
        self.channel.mix_root(root)
        self.roots.append(np.asarray(root, dtype=np.uint32))
        self.tree_trace_logs.append(list(column_trace_logs))

    def verify_values(self, sample_points, proof: PcsProof) -> bool:
        """Check the proof's openings of the committed trees at
        `sample_points` ([tree][col] -> list of QM31 points); False at the
        first check that fails."""
        ch = self.channel
        B = self.config.log_blowup
        # 1. The claimed sampled values (shapes against the points), mixed.
        samples: List[ColumnSample] = []
        for t, tree_pts in enumerate(sample_points):
            if len(proof.sampled_values[t]) != len(tree_pts):
                return False
            for c, pts in enumerate(tree_pts):
                vals = proof.sampled_values[t][c]
                if len(vals) != len(pts):
                    return False
                for pt, v in zip(pts, vals):
                    samples.append(ColumnSample(self.tree_trace_logs[t][c] + B, t, c, pt,
                                                np.asarray(v, dtype=np.uint32)))
        for tree_vals in proof.sampled_values:
            for col_vals in tree_vals:
                for v in col_vals:
                    ch.mix_felts(np.asarray(v, dtype=np.uint32))

        gamma = ch.draw_felt()
        input_logs = sorted({s.commit_log for s in samples}, reverse=True)
        kmax = input_logs[0]

        # 2. The FRI commitments (structure and channel).
        replay = fri_mod.fri_replay(proof.fri_proof, self.config.fri, ch, input_logs)
        if replay is None:
            return False
        alpha0, alphas = replay

        # 3. PoW and queries.
        if not ch.check_pow_nonce(self.config.pow_bits, proof.pow_nonce):
            return False
        ch.mix_u64(proof.pow_nonce)
        positions = ch.draw_queries(self.config.fri.n_queries, kmax)

        # 4. The trees' openings; the opened values at the needed positions.
        need = fri_mod.needed_input_positions(positions, input_logs, self.config.fri)
        opened: Dict[tuple, torch.Tensor] = {}
        for t, logs in enumerate(self.tree_trace_logs):
            commit_logs = [l + B for l in logs]
            queries = {log: need[log] for log in set(commit_logs) if log in need}
            values, witness = proof.tree_queried_values[t], proof.tree_witnesses[t]
            if not verify_decommitment(self.roots[t], commit_logs, queries, values, witness):
                return False
            comp = computed_positions(commit_logs, queries)
            # Values come logs descending, commitment order within a log.
            vi = iter(values)
            for log in sorted(set(commit_logs), reverse=True):
                at = torch.from_numpy(np.searchsorted(comp[log], need[log]))
                for c in [i for i, cl in enumerate(commit_logs) if cl == log]:
                    opened[(t, c)] = f.host_i64(next(vi))[at]

        # 5. The quotients at the needed positions, then FRI at the queries.
        domains = {log: circle.domain_points_at(log, pos) for log, pos in need.items()}
        quots = quotients_at_positions(samples, opened, gamma, domains)

        def query_eval(circle_log, pos):
            at = np.searchsorted(need[circle_log], np.asarray(pos, dtype=np.int64))
            return quots[circle_log][torch.from_numpy(at)]

        return fri_mod.fri_check_queries(proof.fri_proof, self.config.fri, alpha0, alphas, query_eval, input_logs,
                                         positions)
