"""Several devices: the mesh, `prove()` under `prove_mesh`, and the
sharded prover step.

The counterpart of the reference package's parallel/sharding.py in plain
PyTorch.  A `Mesh` is an array of torch devices with axis names, like
`jax.sharding.Mesh`; its device list may repeat a device, so that n
shards run on one card (or on the CPU in the tests): such a mesh runs the
split, the reshard, the per-shard launches and the merge, but no copy
between cards.  The constructors take the first n CUDA devices and raise
`ProverError` when there are fewer; each also takes an explicit device
list.

A tree's commitment under a mesh (`ShardedCommit`):

  * the LDE is COLUMN-parallel: each column shard runs K1 (circle iFFT
    and LDE) on its block of the size group's columns over full rows;
  * the reshard moves the LDE from columns to rows block by block: each
    (source, destination) pair copies only its column block times row
    block into preallocated buffers, never an all-gather; it moves (n -
    1)/n of the tree's words (`moved_bytes`);
  * the Merkle tree is ROW-parallel (crypto/merkle.ShardedMerkleTree):
    each row shard runs K2 on its row block of every column with at least
    one row per shard, the lead device hashes the top log2(n) layers from
    the shards' roots, with the columns that have fewer rows than shards.

Row shards run over the flattened device array (hosts outermost for a
('hosts', 'chips') mesh); column shards too, except on a ('rows', 'cols')
mesh, where the columns split over 'cols' first (the transposed order),
so that there the reshard exchanges blocks between other positions.

Under `prove_mesh` the commitment scheme (pcs/scheme.py) commits every
tree so, runs K7 per column shard on the coefficients it holds and opens
each tree with one K9 pass per row shard and one on the lead.  The AIR
phases (K5, K6) and the FRI chain (K3, K4, K8, K10) run on the lead over
each tree's evaluations, which the lead assembles from the column blocks:
the one gather this design keeps (`gathered_bytes`).  The reference's
`offload_min_rows` is not carried over: the port has no host tail.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import fft
from .. import fields as f
from .. import kernels
from ..crypto.merkle import MerkleTree, ShardedMerkleTree
from ..errors import ProverError


class Mesh:
    """An array of torch devices with axis names (`devices`, an object
    ndarray; `axis_names`).  The lead device is devices.flat[0]."""

    def __init__(self, devices, axis_names: Sequence[str]):
        given = np.asarray(devices, dtype=object)
        self.devices = np.empty(given.shape, dtype=object)
        for i, d in enumerate(given.flat):
            self.devices.flat[i] = f.device_key(d)
        self.axis_names = tuple(axis_names)
        if len(self.axis_names) != self.devices.ndim or not self.devices.size:
            raise ProverError(f"a mesh of shape {given.shape} needs {given.ndim} axis names, got {self.axis_names}")
        if len({d.type for d in self.devices.flat}) != 1:
            raise ProverError("a mesh's devices are all CUDA devices or all the CPU")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    @property
    def lead(self) -> torch.device:
        return self.devices.flat[0]

    @property
    def virtual(self) -> bool:
        """True when a device holds more than one shard."""
        return len(set(self.devices.flat)) < self.size

    def row_shards(self) -> List[Tuple[int, torch.device]]:
        """(mesh position, device) of each row shard, in row order: the
        flattened array."""
        return list(enumerate(self.devices.flat))

    def col_shards(self) -> List[Tuple[int, torch.device]]:
        """(mesh position, device) of each column shard, in column order:
        over 'cols' first on a ('rows', 'cols') mesh, else flattened."""
        pos = np.arange(self.size).reshape(self.devices.shape)
        if self.axis_names == ("rows", "cols"):
            pos = pos.T
        return [(int(p), self.devices.flat[int(p)]) for p in pos.reshape(-1)]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices.flat]})"


def _devices(n: Optional[int], devices) -> List[torch.device]:
    """The first n of `devices`, or of the CUDA devices when it is None;
    ProverError when there are fewer (never a CPU or a repeated device in
    their place)."""
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        n = have if n is None else n
        if n < 1 or n > have:
            raise ProverError(f"need {n} CUDA devices, have {have}")
        return [torch.device("cuda", i) for i in range(n)]
    devices = [f.device_key(d) for d in devices]
    n = len(devices) if n is None else n
    if n < 1 or n > len(devices):
        raise ProverError(f"need {n} devices, {len(devices)} given")
    return devices[:n]


def make_chip_mesh(n_devices: Optional[int] = None, devices=None) -> Mesh:
    """A 1-D ('chips',) mesh over the first n_devices CUDA devices (or of
    `devices`, which may repeat one): the mesh `prove_mesh` expects."""
    return Mesh(_devices(n_devices, devices), ("chips",))


def make_host_chip_mesh(n_hosts: int, n_chips: int, devices=None) -> Mesh:
    """A 2-D ('hosts', 'chips') mesh: host group h holds devices [h n_chips,
    (h + 1) n_chips).  Rows shard over the flattened array, hosts
    outermost."""
    devs = _devices(n_hosts * n_chips, devices)
    return Mesh([devs[h * n_chips : (h + 1) * n_chips] for h in range(n_hosts)], ("hosts", "chips"))


def make_mesh(n_devices: Optional[int] = None, shape: Optional[Tuple[int, int]] = None, devices=None) -> Mesh:
    """A 2-D ('rows', 'cols') mesh; by default most devices on 'rows' and a
    factor of 2 on 'cols' when n_devices is even, as the reference
    factorises."""
    devs = _devices(n_devices, devices)
    n = len(devs)
    if shape is None:
        c = 2 if n % 2 == 0 and n > 1 else 1
        shape = (n // c, c)
    r, c = shape
    if r * c != n:
        raise ProverError(f"mesh shape {shape} does not hold {n} devices")
    return Mesh([devs[i * c : (i + 1) * c] for i in range(r)], ("rows", "cols"))


_MESH: List[Mesh] = []
# The bytes every sharded commitment moved since the last reset: the
# reshards' and the lead's copies from other positions.
BYTES = {"moved": 0, "gathered": 0}


def reset_bytes() -> None:
    BYTES.update(moved=0, gathered=0)


@contextlib.contextmanager
def prove_mesh(mesh: Mesh):
    """Run the enclosed prove() (and verify()) calls over `mesh`:

        with sharding.prove_mesh(sharding.make_chip_mesh(4)):
            proof = prove(pie, settings)

    The proof's bytes are the single-device proof's.  prove() runs on the
    lead device (mesh.devices.flat[0]); its `device` must be None or that
    device, and a PIE's columns must lie there.  The number of devices
    must be a power of two (rows split evenly).  The reference's
    `offload_min_rows` has no counterpart: the port has no host tail."""
    _check_rows(mesh)
    _MESH.append(mesh)
    try:
        yield mesh
    finally:
        _MESH.pop()


def current_mesh() -> Optional[Mesh]:
    return _MESH[-1] if _MESH else None


def _check_rows(mesh: Mesh) -> int:
    n = mesh.size
    if n & (n - 1):
        raise ProverError(f"rows split over a power of two of devices, not {n}")
    return n.bit_length() - 1


def split_evenly(n: int, parts: int) -> List[Tuple[int, int]]:
    """Contiguous [a, b) blocks of n items over `parts`, the first n % parts
    one larger."""
    out, a = [], 0
    for i in range(parts):
        b = a + n // parts + (1 if i < n % parts else 0)
        out.append((a, b))
        a = b
    return out


@dataclass
class ColumnBlock:
    """A column shard's block [c0, c1) of one size group: its coefficients
    and LDE evaluations on its device."""

    pos: int
    c0: int
    c1: int
    coeffs: Optional[torch.Tensor]
    evals: Optional[torch.Tensor]


def _lde_body(mesh: Mesh, mat, log_blowup: int) -> List[ColumnBlock]:
    """Column-parallel: each column shard runs K1 on its block of `mat`'s
    columns ((C, N): a tensor, moved, or host words, uploaded straight to
    the shard), over full rows."""
    blocks = []
    for (pos, dev), (c0, c1) in zip(mesh.col_shards(), split_evenly(mat.shape[0], mesh.size)):
        if c0 == c1:
            continue
        if isinstance(mat, torch.Tensor):
            block = mat[c0:c1].to(dev, non_blocking=True)
        else:
            block = f.u32_to_tensor(mat[c0:c1], dev)
        with kernels.on_shard(pos):
            coeffs = fft.ifft(block)
            evals = fft.extend_coeffs_and_fft(coeffs, log_blowup)
        blocks.append(ColumnBlock(pos, c0, c1, coeffs, evals))
    return blocks


def _reshard(mesh: Mesh, blocks: List[ColumnBlock], n_cols: int, log: int) -> Tuple[List[torch.Tensor], int]:
    """Columns to rows: each row shard's (n_cols, 2^log / n) buffer, filled
    block by block (a column block's row block, copied); and the bytes
    that changed mesh position."""
    shards = mesh.row_shards()
    rows = (1 << log) // len(shards)
    out = [torch.empty((n_cols, rows), dtype=f.I32, device=dev) for _, dev in shards]
    moved = 0
    for b in blocks:
        for r, (pos, _) in enumerate(shards):
            out[r][b.c0 : b.c1].copy_(b.evals[:, r * rows : (r + 1) * rows], non_blocking=True)
            moved += 0 if pos == b.pos else 4 * (b.c1 - b.c0) * rows
    return out, moved


def _gather(mesh: Mesh, blocks: List[ColumnBlock], n_cols: int, log: int) -> Tuple[torch.Tensor, int]:
    """The lead's (n_cols, 2^log) copy of a size group, from the column
    blocks; the bytes that came from other mesh positions."""
    if len(blocks) == 1 and blocks[0].pos == 0:
        return blocks[0].evals, 0
    out = torch.empty((n_cols, 1 << log), dtype=f.I32, device=mesh.lead)
    got = 0
    for b in blocks:
        out[b.c0 : b.c1].copy_(b.evals, non_blocking=True)
        got += 0 if b.pos == 0 else 4 * (b.c1 - b.c0) << log
    return out, got


class ShardedCommit:
    """One tree's commitment under a mesh (module docstring).

    mats: {trace log: (C, 2^log) columns in commitment order}, tensors or
    host words.  `blocks` {commit log: [ColumnBlock]} keep the coefficients
    (for K7); `evals` {commit log: (C, 2^l) on the lead} holds the lead's
    copies when `gather`, else only the groups of fewer rows than shards
    (the top's columns); `tree` is the row-sharded Merkle tree (a plain
    MerkleTree on one shard, or when no group has a row per shard).
    `moved_bytes`: the reshard's; `gathered_bytes`: the lead's copies from
    other positions.  On a mesh of one device this is the one-device
    commit: one column block, no copy, a MerkleTree over every group."""

    def __init__(self, mesh: Mesh, mats: Dict[int, object], log_blowup: int, gather: bool = True):
        s = _check_rows(mesh)
        self.blocks: Dict[int, List[ColumnBlock]] = {}
        self.evals: Dict[int, torch.Tensor] = {}
        self.moved_bytes = self.gathered_bytes = 0
        rows_by_log: Dict[int, List[torch.Tensor]] = {}
        for log, mat in mats.items():
            cl = log + log_blowup
            blocks = _lde_body(mesh, mat, log_blowup)
            if gather or cl < s or s == 0:
                self.evals[cl], got = _gather(mesh, blocks, mat.shape[0], cl)
                self.gathered_bytes += got
            if cl >= s and s > 0:
                rows_by_log[cl], moved = _reshard(mesh, blocks, mat.shape[0], cl)
                self.moved_bytes += moved
            for b in blocks:
                b.evals = None  # the row blocks and the lead's copy hold the values now
            self.blocks[cl] = blocks
        BYTES["moved"] += self.moved_bytes
        BYTES["gathered"] += self.gathered_bytes
        self.tree = _merkle_body(mesh, rows_by_log, {l: e for l, e in self.evals.items() if l < s or s == 0})


def _merkle_body(mesh: Mesh, rows_by_log: Dict[int, List[torch.Tensor]], top_cols: Dict[int, torch.Tensor]):
    """Row-parallel: K2 on each row shard's blocks, the top on the lead."""
    if not rows_by_log:  # one shard, or no group with a row per shard: the whole tree on the lead
        return MerkleTree(top_cols)
    shard_cols = [{log: blocks[r] for log, blocks in rows_by_log.items()} for r in range(mesh.size)]
    return ShardedMerkleTree(shard_cols, top_cols, mesh.lead)


def _logup_sum_body(mesh: Mesh, values: np.ndarray, mult: np.ndarray, z, alpha) -> torch.Tensor:
    """Row-parallel: logup_sum on each row shard's rows (uploaded straight
    to it), the n sums added on the lead: (4,) int32 there."""
    total = torch.zeros(4, dtype=f.I64, device=mesh.lead)
    for (pos, dev), (a, b) in zip(mesh.row_shards(), split_evenly(values.shape[1], mesh.size)):
        if a == b:
            continue
        v, m = f.u32_to_tensor(values[:, a:b], dev), f.u32_to_tensor(mult[a:b], dev)
        with kernels.on_shard(pos):
            part = kernels.logup_sum(v, m, z, alpha)
        total = f.add(total, part.to(mesh.lead).to(f.I64))
    return total.to(f.I32)


def prover_step(mesh: Mesh, cols, mult_m31, z, alpha, log_blowup: int = 1, n_rel_cols: int = 2,
                stats: Optional[dict] = None):
    """One sharded prover step over the mesh: the LDE of the (C, N) uint32
    trace columns (column-parallel, K1), the Merkle root of the
    evaluations (row-parallel, K2 and the top), and the LogUp claimed sum
    of the first n_rel_cols columns with multiplicities mult_m31 (N,)
    (row-parallel, logup_sum).  Returns (evals (C, N << log_blowup), root
    (8,), claimed (4,)) as numpy uint32, the reference's
    `sharding.prover_step` word for word.  `stats`, when given, receives
    the reshard's `moved_bytes` and the evaluations' `tree_bytes`."""
    cols = np.ascontiguousarray(np.asarray(cols, dtype=np.uint32))
    log_n = int(cols.shape[-1]).bit_length() - 1
    if cols.ndim != 2 or 1 << log_n != cols.shape[-1]:
        raise ProverError("prover_step: (C, N) columns, N a power of two")
    commit = ShardedCommit(mesh, {log_n: cols}, log_blowup, gather=False)
    commit.blocks.clear()  # the coefficients serve no OODS value here
    cl, tree = log_n + log_blowup, commit.tree
    if isinstance(tree, ShardedMerkleTree):
        evals = np.concatenate([f.tensor_to_u32(t.cols_by_log[cl - tree.log_shards]) for t in tree.shards], axis=1)
    else:
        evals = f.tensor_to_u32(commit.evals[cl])
    claimed = _logup_sum_body(mesh, cols[:n_rel_cols], np.asarray(mult_m31, dtype=np.uint32), z, alpha)
    if stats is not None:
        stats.update(moved_bytes=commit.moved_bytes, tree_bytes=evals.nbytes)
    return evals, tree.root, f.tensor_to_u32(claimed)


def step_launches(mesh: Mesh, n_cols: int, log_n: int, log_blowup: int = 1) -> Dict[str, int]:
    """The launches `prover_step` makes on the card, and no others: K1's
    passes (the iFFT's and the LDE's, kernels.fft_passes) once per column
    shard that holds columns; K2's passes (kernels.merkle_passes) of each
    row shard's tree and of the top (or of the whole tree on one shard);
    one logup_sum per row shard that holds rows."""
    s, L = _check_rows(mesh), log_n + log_blowup
    blocks = sum(1 for a, b in split_evenly(n_cols, mesh.size) if a < b)
    k1 = (len(kernels.fft_passes(log_n, 1, True)) if log_n else 0) + len(
        kernels.fft_passes(L, 2 if log_blowup == 1 and log_n > 0 else 1, False))
    if s == 0 or L < s:
        k2 = len(kernels.merkle_passes(L))
    else:
        k2 = mesh.size * len(kernels.merkle_passes(L - s)) + len(kernels.merkle_passes(s - 1))
    rows = sum(1 for a, b in split_evenly(1 << log_n, mesh.size) if a < b)
    return {"circle_fft": blocks * k1, "blake2s_merkle": k2, "logup_sum": rows}
