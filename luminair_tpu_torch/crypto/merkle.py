"""Mixed-size column Merkle commitments (Blake2s), layers on the device.

One tree commits columns of several power-of-two lengths:

  layer L (bottom, L = max column log): node[i] = H(cols_at_L[.., i])
  layer l < L:  node[i] = H(child0 || child1 || cols_at_l[.., i])
  root = layer 0, one digest (8 words).

The layers are views of one allocation.  A tree first records its
descriptor (kernels.TreeDesc: its layers' and columns' addresses and
strides, one upload), which the Merkle kernel (kernels.merkle_tree, K2)
and the decommitment kernel both read; K2 then hashes the whole tree in a
few launches, reading the columns of each log through their (k, 2^l)
view: the rows of an LDE output matrix, or the transposed (2^l, 4) QM31
layer of a FRI fold, whose root pass also mixes the root into the FRI
channel on the card and draws the layer's alpha (K8's step).  The layers
stay on the device; the root and the queried openings are the only
downloads.

Decommitment (the reference package's crypto/merkle.py): per layer, the set
of nodes the verifier recomputes is

  computed[bottom] = queries[bottom]
  computed[l]      = parents(computed[l+1])  |  queries[l]

The witness is the child digests the verifier lacks, in (layer desc,
position asc, child asc) order; opened column values are given at every
computed position of their layer, logs descending, columns in order.  All
of it -- the sets, the witness and the values of every tree of a pass --
is one launch of K9 (kernels.decommit) and one download (`open_trees`).

Under a mesh (parallel/sharding.py) a tree is row-sharded
(`ShardedMerkleTree`): with n = 2^s row shards, shard r holds rows [r
2^l / n, (r + 1) 2^l / n) of every column of log l >= s and hashes them
as a tree of its own (K2 on its device); its root is node r of layer s.
The lead device hashes layers s - 1 .. 0 from the n roots, with the
columns of fewer rows than shards joining there.  Its decommitment is one
pass a shard over the shard's layers and row blocks and one on the lead
over the top, merged layer by layer (`open_trees`).

The verifier's side (`computed_positions`, `verify_decommitment`) runs on
the host: sorted numpy positions, each node hashed with hashlib.
"""

from __future__ import annotations

import hashlib
from collections import Counter
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import fields as f
from .. import kernels
from .. import tracing


class MerkleTree:
    def __init__(self, cols_by_log: Dict[int, torch.Tensor], state: Optional[torch.Tensor] = None,
                 slot: Optional[torch.Tensor] = None, leaves: Optional[torch.Tensor] = None):
        """cols_by_log: {log: (k, 2^log) int32 view of the columns of that
        log, in commitment order}.  A FRI layer's tree also takes the
        channel `state` and its record `slot`: K8's step (mix the root, draw
        the layer's alpha) then runs in the pass that writes the root.

        `leaves`, (2^s, 8) int32 digests on one device, make the tree the
        top of a row-sharded one: its bottom layer s holds them (the
        shards' roots), its columns are those of logs below s, and K2
        hashes from layer s - 1 up."""
        self.cols_by_log = dict(cols_by_log)
        for log, cols in self.cols_by_log.items():
            assert cols.dim() == 2 and cols.shape[1] == 1 << log
        if leaves is None:
            assert cols_by_log, "empty tree"
            self.max_log = max(self.cols_by_log)
            dev = self.cols_by_log[self.max_log].device
        else:
            self.max_log = int(leaves.shape[0]).bit_length() - 1
            assert self.max_log >= 1 and leaves.shape == (1 << self.max_log, 8)
            assert all(log < self.max_log for log in self.cols_by_log)
            dev = leaves.device
        self.layers = kernels.tree_layers(self.max_log, dev)
        if leaves is not None:
            self.layers[self.max_log].copy_(leaves)
        self.desc = kernels.TreeDesc(self.layers, self.cols_by_log)
        if leaves is None:
            kernels.merkle_tree(self.desc, state, slot)
        else:
            kernels.merkle_tree(self.desc, state, slot, start=self.max_log - 1)
        self._root = None

    @property
    def root(self) -> np.ndarray:
        """(8,) uint32 root words (downloaded once)."""
        if self._root is None:
            self._root = f.tensor_to_u32(self.layers[0][0])
        return self._root


class ShardedMerkleTree:
    """A tree whose rows lie on n = 2^s row shards (module docstring).

    shard_cols[r]: {log: (k, 2^log / n) int32} on the device of shard r
    (mesh position r: row shards run over the flattened mesh), for
    every log >= s (the same logs and k on every shard), rows [r 2^log /
    n, (r + 1) 2^log / n) of those columns; top_cols: {log < s: (k,
    2^log)} on `lead`.  K2 hashes each shard's block as a tree of bottom
    L - s, then the top on the lead (`MerkleTree(leaves=...)`), whose root
    pass takes the channel `state` and `slot` when given."""

    def __init__(self, shard_cols: List[Dict[int, torch.Tensor]], top_cols: Dict[int, torch.Tensor],
                 lead: torch.device, state: Optional[torch.Tensor] = None, slot: Optional[torch.Tensor] = None):
        n = len(shard_cols)
        self.log_shards = s = n.bit_length() - 1
        assert s >= 1 and n == 1 << s
        self.shards = []
        for r, cols in enumerate(shard_cols):
            with kernels.on_shard(r):
                self.shards.append(MerkleTree({log - s: c for log, c in cols.items()}))
        roots = torch.empty((n, 8), dtype=f.I32, device=lead)
        for r, t in enumerate(self.shards):
            roots[r].copy_(t.layers[0][0], non_blocking=True)
        with kernels.on_shard("lead"):
            self.top = MerkleTree(top_cols, state, slot, leaves=roots)
        self.max_log = s + self.shards[0].max_log

    @property
    def root(self) -> np.ndarray:
        return self.top.root

    def split_queries(self, queries: Dict[int, np.ndarray]) -> tuple:
        """Global queries {log: sorted positions} -> (per shard its queries
        on its own tree, the top's queries: at layer s the shards that hold
        a queried row, below it the queries of the top's columns)."""
        s = self.log_shards
        shard_q = [{} for _ in self.shards]
        top_q = {log: np.asarray(p, dtype=np.int64) for log, p in queries.items() if log < s}
        at_s = []
        for log, pos in queries.items():
            if log < s:
                continue
            pos = np.asarray(pos, dtype=np.int64)
            owner = pos >> (log - s)
            at_s.append(owner)
            for r in np.unique(owner).tolist():
                shard_q[r][log - s] = pos[owner == r] - (r << (log - s))
        if at_s:
            top_q[s] = np.unique(np.concatenate(at_s))
        return shard_q, top_q


def open_trees(trees: List, queries: List[Dict[int, np.ndarray]]) -> List[tuple]:
    """Open every tree at its queries ({log: sorted distinct positions}).
    Plain trees and the tops of row-sharded ones are one decommitment pass
    on the lead: one upload, one launch of K9, one download; each row
    shard that holds a queried row is one pass more over its blocks, on
    its device.  Returns per tree (values: one array per column, logs
    descending, commitment order; witness: (n, 8) uint32 digests)."""
    with tracing.span("3b_decommit.plan"):
        lead, shards = [], {}  # (tree index, desc, queries); shard r -> the same
        for i, (t, q) in enumerate(zip(trees, queries)):
            if isinstance(t, ShardedMerkleTree):
                shard_q, top_q = t.split_queries(q)
                for r, sq in enumerate(shard_q):
                    if sq:
                        shards.setdefault(r, []).append((i, t.shards[r].desc, sq))
                lead.append((i, t.top.desc, top_q))
            else:
                lead.append((i, t.desc, q))
        plans = {r: kernels.DecommitPass([d for _, d, _ in p], [q for _, _, q in p]) for r, p in shards.items()}
        lead_plan = kernels.DecommitPass([d for _, d, _ in lead], [q for _, _, q in lead])
    with tracing.span("3b_decommit.launch_download"):
        outs = {}
        for r, plan in plans.items():
            with kernels.on_shard(r):
                outs[r] = kernels.decommit(plan)
        with kernels.on_shard("lead"):
            lead_out = kernels.decommit(lead_plan)
        lead_words = f.tensor_to_u32(lead_out)
        shard_words = {r: f.tensor_to_u32(w) for r, w in outs.items()}
    with tracing.span("3b_decommit.assembly"):
        result = lead_plan.split(lead_words)  # a sharded tree's entry: its top's, replaced below
        sharded = [j for j, (i, _, _) in enumerate(lead) if isinstance(trees[i], ShardedMerkleTree)]
        if sharded:
            parts = {}  # tree index -> [(shard, values by log, witness by layer)]
            for r, plan in plans.items():
                for (i, _, _), opened in zip(shards[r], plan.split_layers(shard_words[r])):
                    parts.setdefault(i, []).append((r, *opened))
            tops = lead_plan.split_layers(lead_words)
            for j in sharded:
                i = lead[j][0]
                result[j] = _merge_shards(trees[i], sorted(parts.get(i, []), key=lambda p: p[0]), tops[j])
        return result


def _merge_shards(t: ShardedMerkleTree, parts: List[tuple], top: tuple) -> tuple:
    """One sharded tree's opening in the whole tree's order from its
    shards' passes (in shard order, which is position order: the blocks are
    contiguous) and the top's: values logs descending, each column's
    values over the shards in turn; witness layer by layer, the shards'
    layers above s, then the top's."""
    s = t.log_shards
    shard_cols = t.shards[0].cols_by_log
    values = []
    for log in sorted({log + s for log in shard_cols} | set(top[0]), reverse=True):
        if log < s:
            values.extend(top[0][log])
            continue
        for c in range(shard_cols[log - s].shape[0]):
            values.append(np.concatenate([np.zeros(0, dtype=np.uint32)] + [vals[log - s][c] for _, vals, _ in parts]))
    witness = []
    for layer in range(t.max_log, s, -1):
        witness.extend(wit[layer - s] for _, _, wit in parts if layer - s in wit)
    witness.extend(top[1][layer] for layer in sorted(top[1], reverse=True))
    return values, np.concatenate(witness) if witness else np.zeros((0, 8), dtype=np.uint32)


def computed_positions(column_logs, queries_per_log) -> Dict[int, np.ndarray]:
    """Per layer, the sorted int64 positions of the nodes the verifier
    recomputes, {log: array}, from the bottom layer (max of column_logs)
    up to the root."""
    bottom = max(column_logs)
    s = np.unique(np.asarray(queries_per_log.get(bottom, []), dtype=np.int64))
    out = {bottom: s}
    for log in range(bottom - 1, -1, -1):
        s = np.union1d(s >> 1, np.asarray(queries_per_log.get(log, []), dtype=np.int64))
        out[log] = s
    return out


def verify_decommitment(root, column_logs, queries_per_log: dict, queried_values, witness) -> bool:
    """Recompute the root from the opened column values (one array per
    column, logs descending, commitment order, at every computed position
    of their layer) and the witness digests, consumed in (layer desc,
    position asc, child asc) order.  False on short values, a missing
    witness digest, trailing witness data or a root that differs."""
    cols_count = Counter(column_logs)
    bottom = max(cols_count)
    comp = computed_positions([bottom], queries_per_log)

    values_iter = iter(queried_values)
    values_by_log = {}
    try:
        for log in sorted(cols_count, reverse=True):
            values_by_log[log] = [np.asarray(next(values_iter), dtype=np.uint32) for _ in range(cols_count[log])]
    except StopIteration:
        return False
    for log, vals in values_by_log.items():
        if any(len(v) != len(comp[log]) for v in vals):
            return False

    def rows(log, n):
        """The opened values of the columns of `log`, one message tail per
        computed position."""
        vals = values_by_log.get(log, [])
        if not vals:
            return [b""] * n
        return [r.tobytes() for r in np.stack(vals, axis=1).astype("<u4")]

    witness_iter = iter(witness)
    s = comp[bottom]
    nodes: Dict[int, bytes] = {}
    if len(s):
        if not values_by_log.get(bottom):
            return False
        nodes = {int(p): hashlib.blake2s(m).digest() for p, m in zip(s, rows(bottom, len(s)))}
    for log in range(bottom, 0, -1):
        nxt = comp[log - 1]
        tails = rows(log - 1, len(nxt))
        parents = {}
        for par, tail in zip(nxt.tolist(), tails):
            children = []
            for child in (2 * par, 2 * par + 1):
                digest = nodes.get(child)
                if digest is None:
                    w = next(witness_iter, None)
                    if w is None:
                        return False
                    digest = np.broadcast_to(np.asarray(w, dtype=np.uint32), (8,)).astype("<u4").tobytes()
                children.append(digest)
            parents[par] = hashlib.blake2s(children[0] + children[1] + tail).digest()
        nodes = parents
    if list(nodes) != [0]:
        return False
    if next(witness_iter, None) is not None:
        return False  # trailing witness data
    return bool(np.array_equal(np.frombuffer(nodes[0], dtype="<u4"), np.asarray(root)))
