"""Mixed-size column Merkle commitments (Blake2s), layers on the device.

One tree commits columns of several power-of-two lengths:

  layer L (bottom, L = max column log): node[i] = H(cols_at_L[.., i])
  layer l < L:  node[i] = H(child0 || child1 || cols_at_l[.., i])
  root = layer 0, one digest (8 words).

Each layer is one launch of the Merkle kernel (kernels.merkle_layer), which
reads the columns of its log through a (k, 2^l) view: the rows of an LDE
output matrix, or the transposed (2^l, 4) QM31 layer of a FRI fold.  The
layers stay on the device; the root and the queried openings are the only
downloads, the openings of a whole pass in one launch and one transfer
(`gather_many`, K9).

Decommitment (the reference package's crypto/merkle.py): per layer, the set
of nodes the verifier recomputes is

  computed[bottom] = queries[bottom]
  computed[l]      = parents(computed[l+1])  |  queries[l]

The witness is the child digests the verifier lacks, in (layer desc,
position asc, child asc) order; opened column values are given at every
computed position of their layer, logs descending, columns in order.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from .. import fields as f
from .. import kernels

# A gather: (source tensor, positions, axis).
GatherSpec = Tuple[torch.Tensor, List[int], int]


def computed_positions(column_logs, queries_per_log):
    """Per-layer recomputed-node positions, {log: sorted list}."""
    bottom = max(column_logs)
    out = {}
    s = sorted({int(p) for p in queries_per_log.get(bottom, [])})
    out[bottom] = s
    for log in range(bottom - 1, -1, -1):
        s = sorted({p >> 1 for p in s} | {int(p) for p in queries_per_log.get(log, [])})
        out[log] = s
    return out


class MerkleTree:
    def __init__(self, cols_by_log: Dict[int, torch.Tensor]):
        """cols_by_log: {log: (k, 2^log) int32 view of the columns of that
        log, in commitment order}."""
        assert cols_by_log, "empty tree"
        self.cols_by_log = dict(cols_by_log)
        for log, cols in self.cols_by_log.items():
            assert cols.dim() == 2 and cols.shape[1] == 1 << log
        self.max_log = max(self.cols_by_log)
        self.layers: Dict[int, torch.Tensor] = {}
        prev = None
        for log in range(self.max_log, -1, -1):
            prev = kernels.merkle_layer(prev, self.cols_by_log.get(log))
            self.layers[log] = prev
        self._root = None

    @property
    def root(self) -> np.ndarray:
        """(8,) uint32 root words (downloaded once)."""
        if self._root is None:
            self._root = f.tensor_to_u32(self.layers[0][0])
        return self._root

    def decommit_plan(self, queries_per_log: dict):
        """(gather specs, assemble): assemble(results) -> witness digests."""
        bottom = self.max_log
        comp = computed_positions([bottom, 0], queries_per_log)
        known = set(comp[bottom])
        specs: List[GatherSpec] = []
        for log in range(bottom, 0, -1):
            idx = [
                child
                for par in comp[log - 1]
                for child in (2 * par, 2 * par + 1)
                if child not in known
            ]
            if idx:
                specs.append((self.layers[log], idx, 0))
            known = set(comp[log - 1])

        def assemble(results):
            return [row for block in results for row in block]

        return specs, assemble

    def queried_values_plan(self, queries_per_log: dict):
        """(gather specs, assemble): assemble(results) -> one value array per
        column, logs descending, commitment order within a log."""
        comp = computed_positions([self.max_log, 0], queries_per_log)
        specs: List[GatherSpec] = [
            (self.cols_by_log[log], comp[log], 1) for log in sorted(self.cols_by_log, reverse=True)
        ]

        def assemble(results):
            return [np.ascontiguousarray(col) for block in results for col in block]

        return specs, assemble


def gather_many(specs: List[GatherSpec]) -> List[np.ndarray]:
    """Run every gather on the device in one launch of the gather kernel
    (kernels.gather, K9: one upload of the spec table and indices) and
    download them in one transfer.  Returns uint32 arrays: (k, len) for
    axis-1 specs, (len, 8) for axis-0."""
    if not specs:
        return []
    flat = f.tensor_to_u32(kernels.gather(specs))
    out, off = [], 0
    for spec in specs:
        shape = kernels.gather_shape(spec)
        size = int(np.prod(shape))
        out.append(flat[off : off + size].reshape(shape))
        off += size
    return out


def run_plans(plans):
    """[(values plan, witness plan)] -> [(values, witness)] in one download."""
    specs = [s for (q, _), (d, _) in plans for s in q + d]
    results = gather_many(specs)
    out, off = [], 0
    for (q_specs, q_asm), (d_specs, d_asm) in plans:
        values = q_asm(results[off : off + len(q_specs)])
        off += len(q_specs)
        witness = d_asm(results[off : off + len(d_specs)])
        off += len(d_specs)
        out.append((values, witness))
    return out
