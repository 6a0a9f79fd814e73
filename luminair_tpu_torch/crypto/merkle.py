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
                 slot: Optional[torch.Tensor] = None):
        """cols_by_log: {log: (k, 2^log) int32 view of the columns of that
        log, in commitment order}.  A FRI layer's tree also takes the
        channel `state` and its record `slot`: K8's step (mix the root, draw
        the layer's alpha) then runs in the pass that writes the root."""
        assert cols_by_log, "empty tree"
        self.cols_by_log = dict(cols_by_log)
        for log, cols in self.cols_by_log.items():
            assert cols.dim() == 2 and cols.shape[1] == 1 << log
        self.max_log = max(self.cols_by_log)
        self.layers = kernels.tree_layers(self.max_log, self.cols_by_log[self.max_log].device)
        self.desc = kernels.TreeDesc(self.layers, self.cols_by_log)
        kernels.merkle_tree(self.desc, state, slot)
        self._root = None

    @property
    def root(self) -> np.ndarray:
        """(8,) uint32 root words (downloaded once)."""
        if self._root is None:
            self._root = f.tensor_to_u32(self.layers[0][0])
        return self._root


def open_trees(trees: List[MerkleTree], queries: List[Dict[int, np.ndarray]]) -> List[tuple]:
    """Open every tree at its queries ({log: sorted distinct positions}) in
    one decommitment pass: one upload, one launch of K9, one download.
    Returns per tree (values: one array per column, logs descending,
    commitment order; witness: (n, 8) uint32 digests)."""
    timer = tracing.current("prove")
    with timer.span("3b_decommit.plan"):
        plan = kernels.DecommitPass([t.desc for t in trees], queries)
    with timer.span("3b_decommit.launch_download"):
        words = f.tensor_to_u32(kernels.decommit(plan))
    with timer.span("3b_decommit.assembly"):
        return plan.split(words)


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
