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
    columns that arrive as row blocks on the row shards (`RowBlocks`: the
    interaction, the composition) first reach the column shards by the
    inverse block exchange, never through the lead;
  * the reshard moves the LDE from columns to rows block by block: each
    (source, destination) pair copies only its column block times row
    block into preallocated buffers, never an all-gather; it moves (n -
    1)/n of the tree's words;
  * the Merkle tree is ROW-parallel (crypto/merkle.ShardedMerkleTree):
    each row shard runs K2 on its row block of every column with at least
    one row per shard, the lead device hashes the top log2(n) layers from
    the shards' roots, with the columns that have fewer rows than shards.

Row shards run over the flattened device array (hosts outermost for a
('hosts', 'chips') mesh); column shards too, except on a ('rows', 'cols')
mesh, where the columns split over 'cols' first (the transposed order),
so that there the reshard exchanges blocks between other positions.

Under `prove_mesh` every phase of prove() runs where its data lies; the
committed trees' row blocks stay on the row shards (pcs/scheme.TreeProver
hands them on as RowBlocks), and a phase launches on each row shard
(counted under kernels.on_shard):

  * K5 (`air_witness_many`), one launch a shard over its block of every
    component's padded trace columns, which the lead scatters; each
    shard's totals go to the lead in one copy, their prefix sums come back
    as carries, one copy a shard, and each shard but the first launches
    one carry pass over its blocks of every component (K5's carry pass);
  * K6 (`air_domain_many`), one launch a shard over its block of every
    commit domain, each component with its halo: the next shard's first
    2^B rows of each column read at the next row, the previous shard's
    last 2^B rows of the last LogUp entry, wrapping at the domain's ends;
    the working domain's sum is the composition's row blocks, the smaller
    domains' interpolation and the down-commit run on the column shards
    (K1; `add_strided_coeffs`, `add_coeff_evals`, `down_commit`);
  * K7 per column shard on the coefficients it holds; K4 one plan a row
    shard over its blocks of every column whose commit log has a row per
    shard (pcs/quotients.py);
  * the FRI chain (pcs/fri.commit_chain): while a layer's folds leave a
    row a shard, its tree is a ShardedMerkleTree with K8's step in the
    top's root pass on the lead, the alpha goes to each shard by a copy
    in stream order, and each shard runs K3 on the rows its output block
    needs, assembled in nested mirror order from up to 2^F shards;
  * K9 one pass a row shard and one on the lead; K10 on the lead.

A component with fewer trace rows than shards runs K5 and K6 on the lead
(its commit-domain columns gathered there).  The lead gathers nothing
else but (`expected_gathered_bytes`, with 16-byte QM31 rows, 4-byte
words, n shards, the lead's own block never counted):

  gathered = sum over the trees' size groups of commit log l < log2(n):
               4 2^l (C - C_0)       (C columns, C_0 on the lead's shard)
           + 16 2^g (n - 1) / n      (the FRI layer the chain gathers:
                                      the first whose folds leave fewer
                                      rows than shards, else the last;
                                      none when the largest input's
                                      circle fold leaves fewer)
           + 16 2^k (n - 1) / n      for each FRI input of circle log
                                      k >= log2(n) that joins the chain
                                      on the lead from there on.

`BYTES` counts them, the bytes moved between shards and those scattered
from the lead: the column blocks of the columns that lie there (the main
and preprocessed trees', a small component's quotients) to the other
column shards, and K5's trace blocks to the other row shards.  The reference's `offload_min_rows` is not carried over:
the port has no host tail.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

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
# The bytes the mesh's copies carried since the last reset, counted by mesh
# position (a copy within one position is free): "moved" between shards
# (the block exchanges, halos, FRI assemblies, carries and challenges),
# "gathered" onto the lead (whole tensors assembled there), "scattered"
# from the columns that lie on the lead to the other shards (column
# blocks to the column shards, K5's trace blocks to the row shards).
BYTES = {"moved": 0, "gathered": 0, "scattered": 0}


def reset_bytes() -> None:
    BYTES.update(moved=0, gathered=0, scattered=0)


@contextlib.contextmanager
def prove_mesh(mesh: Mesh):
    """Run the enclosed prove() (and verify()) calls over `mesh`:

        with sharding.prove_mesh(sharding.make_chip_mesh(4)):
            proof = prove(pie, settings)

    The proof's bytes are the single-device proof's.  prove()'s device is
    the lead (mesh.devices.flat[0]): its `device` must be None or that
    device, a PIE's columns must lie there, and the transcript's kernels
    (K8, K10) run there; its phases run on the shards (module docstring).
    The number of devices must be a power of two (rows split evenly).
    The reference's `offload_min_rows` has no counterpart: the port has
    no host tail."""
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


class RowBlocks(list):
    """A column set's row blocks over a mesh's row shards: block r lies on
    row shard r (mesh position r) and holds rows [r R, (r + 1) R) of every
    column, R the rows over the shard count.  `dim` is the blocks' row
    dimension: -1 for columns, (R,) or (C, R); 0 for QM31 rows (R, 4)."""

    def __init__(self, mesh: Mesh, blocks, dim: int = -1):
        super().__init__(blocks)
        self.mesh, self.dim = mesh, dim
        assert len(self) == mesh.size

    @property
    def n_rows(self) -> int:
        return len(self) * self[0].shape[self.dim]


def n_rows(x) -> int:
    return x.n_rows if isinstance(x, RowBlocks) else x.shape[-1]


def count_bytes(kind: str, src_pos: int, dst_pos: int, t: torch.Tensor) -> None:
    """Add t's bytes to BYTES[kind] when the copy changes mesh position."""
    if src_pos != dst_pos:
        BYTES[kind] += t.numel() * t.element_size()


def on_lead(x):
    """A RowBlocks' whole tensor on the lead (the gather: the blocks from
    other positions counted); any other value as it is."""
    if not isinstance(x, RowBlocks):
        return x
    dim = x.dim % x[0].dim()
    shape = list(x[0].shape)
    R, shape[dim] = shape[dim], x.n_rows
    out = torch.empty(shape, dtype=x[0].dtype, device=x.mesh.lead)
    for r, b in enumerate(x):
        out.narrow(dim, r * R, R).copy_(b, non_blocking=True)
        count_bytes("gathered", r, 0, b)
    return out


def to_shards(mesh: Mesh, t: torch.Tensor) -> List[torch.Tensor]:
    """A small tensor on the lead (a challenge, a carry) on every row shard's
    device, in stream order: a copy where the device is another."""
    out = []
    for r, (_, dev) in enumerate(mesh.row_shards()):
        out.append(t.to(dev, non_blocking=True))
        count_bytes("moved", 0, r, t)
    return out


def stack(cols: list):
    """One size group's columns as a matrix: (C, N) from tensors, or
    RowBlocks of (C, R) from RowBlocks of (R,) (a stack on each shard)."""
    if all(isinstance(c, RowBlocks) for c in cols):
        mesh = cols[0].mesh
        return RowBlocks(mesh, [torch.stack([c[r] for c in cols]) for r in range(mesh.size)])
    assert not any(isinstance(c, RowBlocks) for c in cols), "a size group lies on the lead or on the shards"
    return torch.stack([c.to(f.I32) for c in cols])


def unbind(x) -> list:
    """The rows of a (C, N) matrix, or of RowBlocks of (C, R): RowBlocks
    of (R,) views."""
    if isinstance(x, RowBlocks):
        return [RowBlocks(x.mesh, [b[k] for b in x]) for k in range(x[0].shape[0])]
    return list(x.unbind(0))


@dataclass
class ColumnBlock:
    """A column shard's block [c0, c1) of one size group: its coefficients
    and evaluations on its device."""

    pos: int
    c0: int
    c1: int
    coeffs: Optional[torch.Tensor]
    evals: Optional[torch.Tensor]


def _col_blocks(mesh: Mesh, mat) -> List[ColumnBlock]:
    """Each column shard's block of `mat`'s columns over full rows, in
    `evals`: from a (C, N) tensor on the lead (copied to the shard, its
    bytes counted as scattered), host words (uploaded straight to it) or
    RowBlocks of (C, R) -- the inverse of `_reshard`'s block exchange,
    never through the lead, its bytes counted as moved."""
    n_cols = mat[0].shape[0] if isinstance(mat, RowBlocks) else mat.shape[0]
    blocks = []
    for (pos, dev), (c0, c1) in zip(mesh.col_shards(), split_evenly(n_cols, mesh.size)):
        if c0 == c1:
            continue
        if isinstance(mat, RowBlocks):
            R = mat[0].shape[-1]
            block = torch.empty((c1 - c0, mat.n_rows), dtype=f.I32, device=dev)
            for r, b in enumerate(mat):
                part = block[:, r * R : (r + 1) * R]
                part.copy_(b[c0:c1], non_blocking=True)
                count_bytes("moved", r, pos, part)
        elif isinstance(mat, torch.Tensor):
            block = mat[c0:c1].to(dev, non_blocking=True)
            count_bytes("scattered", 0, pos, block)
        else:
            block = f.u32_to_tensor(mat[c0:c1], dev)
        blocks.append(ColumnBlock(pos, c0, c1, None, block))
    return blocks


def _lde_body(mesh: Mesh, mat, log_blowup: int) -> List[ColumnBlock]:
    """Column-parallel: each column shard runs K1 on its block of `mat`'s
    columns (`_col_blocks`) over full rows."""
    blocks = _col_blocks(mesh, mat)
    for b in blocks:
        with kernels.on_shard(b.pos):
            b.coeffs = fft.ifft(b.evals)
            b.evals = fft.extend_coeffs_and_fft(b.coeffs, log_blowup)
    return blocks


def _reshard(mesh: Mesh, blocks: List[ColumnBlock], n_cols: int, log: int) -> List[torch.Tensor]:
    """Columns to rows: each row shard's (n_cols, 2^log / n) buffer, filled
    block by block (a column block's row block, copied); the bytes that
    change mesh position counted as moved."""
    shards = mesh.row_shards()
    rows = (1 << log) // len(shards)
    out = [torch.empty((n_cols, rows), dtype=f.I32, device=dev) for _, dev in shards]
    for b in blocks:
        for r, (pos, _) in enumerate(shards):
            out[r][b.c0 : b.c1].copy_(b.evals[:, r * rows : (r + 1) * rows], non_blocking=True)
            count_bytes("moved", b.pos, pos, out[r][b.c0 : b.c1])
    return out


def _gather(mesh: Mesh, blocks: List[ColumnBlock], n_cols: int, log: int) -> torch.Tensor:
    """The lead's (n_cols, 2^log) copy of a size group, from the column
    blocks; the bytes from other positions counted as gathered."""
    if len(blocks) == 1 and blocks[0].pos == 0:
        return blocks[0].evals
    out = torch.empty((n_cols, 1 << log), dtype=f.I32, device=mesh.lead)
    for b in blocks:
        out[b.c0 : b.c1].copy_(b.evals, non_blocking=True)
        count_bytes("gathered", b.pos, 0, b.evals)
    return out


class ShardedCommit:
    """One tree's commitment under a mesh (module docstring).

    mats: {trace log: (C, 2^log) columns in commitment order}: tensors,
    host words, or RowBlocks of (C, 2^log / n) on the row shards.
    `blocks` {commit log: [ColumnBlock]} keep the coefficients (for K7);
    `evals` {commit log: (C, 2^l) on the lead} holds the groups of fewer
    rows than shards (the top's columns; every group on one shard); `tree`
    is the row-sharded Merkle tree (a plain MerkleTree on one shard, or
    when no group has a row per shard), whose shards hold every other
    group's row blocks.  `moved_bytes`: the exchanges' and the reshards';
    `gathered_bytes`: the lead's copies from other positions.  On a mesh
    of one device this is the one-device commit: one column block, no
    copy, a MerkleTree over every group."""

    def __init__(self, mesh: Mesh, mats: Dict[int, object], log_blowup: int):
        s = _check_rows(mesh)
        self.blocks: Dict[int, List[ColumnBlock]] = {}
        self.evals: Dict[int, torch.Tensor] = {}
        before = dict(BYTES)
        rows_by_log: Dict[int, List[torch.Tensor]] = {}
        for log, mat in mats.items():
            cl = log + log_blowup
            n_cols = mat[0].shape[0] if isinstance(mat, RowBlocks) else mat.shape[0]
            blocks = _lde_body(mesh, mat, log_blowup)
            if cl < s or s == 0:
                self.evals[cl] = _gather(mesh, blocks, n_cols, cl)
            else:
                rows_by_log[cl] = _reshard(mesh, blocks, n_cols, cl)
            for b in blocks:
                b.evals = None  # the row blocks and the lead's copy hold the values now
            self.blocks[cl] = blocks
        self.moved_bytes = BYTES["moved"] - before["moved"]
        self.gathered_bytes = BYTES["gathered"] - before["gathered"]
        self.tree = _merkle_body(mesh, rows_by_log, self.evals)

    def row_blocks(self, mesh: Mesh, cl: int, j: int) -> RowBlocks:
        """Column j of commit log cl's group as RowBlocks of (R,) views of
        the tree's shard blocks."""
        s = self.tree.log_shards
        return RowBlocks(mesh, [t.cols_by_log[cl - s][j] for t in self.tree.shards])


def _merkle_body(mesh: Mesh, rows_by_log: Dict[int, List[torch.Tensor]], top_cols: Dict[int, torch.Tensor]):
    """Row-parallel: K2 on each row shard's blocks, the top on the lead."""
    if not rows_by_log:  # one shard, or no group with a row per shard: the whole tree on the lead
        return MerkleTree(top_cols)
    shard_cols = [{log: blocks[r] for log, blocks in rows_by_log.items()} for r in range(mesh.size)]
    return ShardedMerkleTree(shard_cols, top_cols, mesh.lead)


def expected_gathered_bytes(n: int, tree_logs: List[List[int]], log_blowup: int, fri_config) -> int:
    """The bytes a prove over n row shards gathers onto the lead (module
    docstring's formula), from each tree's columns' trace logs (the
    verifier's layout: `pp_logs()`, `main_logs`, `inter_logs`, the
    composition's 4 columns) and the proof's effective FRI config.  It
    assumes that every component has at least n trace rows (a smaller
    one's K6 also gathers its columns)."""
    s = n.bit_length() - 1
    if n == 1:
        return 0
    total = 0
    for logs in tree_logs:
        for log in set(logs):
            cols = logs.count(log)
            if log + log_blowup < s:  # the top's columns, but the lead's own column block
                total += 4 * (cols - split_evenly(cols, n)[0][1]) << (log + log_blowup)

    def rows(log: int) -> int:  # a row-sharded QM31 vector of 2^log rows, less the lead's block
        return 16 * ((1 << log) - (1 << (log - s)))

    inputs = sorted({l + log_blowup for logs in tree_logs for l in logs}, reverse=True)
    kmax = inputs[0]
    last = fri_config.log_blowup_factor + fri_config.log_last_layer_degree_bound
    F = max(1, int(fri_config.folds_per_layer))
    sharded = kmax >= s + 1
    if not sharded:
        return total + sum(rows(l) for l in inputs if l >= s)
    lead_logs = []  # the circle logs of the inputs that join on the lead
    log = kmax - 1
    while log > last:
        folds = min(F, log - last)
        if sharded and 1 << (log - folds) < n:
            sharded = False
            total += rows(log)
        if not sharded:
            lead_logs += [l for l in range(log - folds + 1, log + 1) if l in inputs]
        log -= folds
    if sharded:
        total += rows(last)
    return total + sum(rows(l) for l in lead_logs if l >= s)


# --- the AIR phases on row shards ------------------------------------------


def air_witness_many(mesh: Mesh, comps: Iterable[tuple], ew) -> List[tuple]:
    """K5 of every component, comps: (witness tape, main, pp) each, the
    padded trace columns on the lead.  Returns (interaction, claimed sum)
    of each in order: the interaction (4E, N), or RowBlocks of (4E, N / n)
    over n row shards; the claimed sum (4,) on the lead.

    On one shard, one launch of every component on the lead (its claimed
    sums rows of one (C, 4)).  Over n shards a component with fewer trace
    rows than shards runs on the lead, whole; every other runs on each row
    shard's block of its columns (scattered from the lead, bytes counted):
    one launch a shard over its blocks of every component (on the lead with
    the whole ones too).  Then, for all of them together: each shard's
    totals (its blocks' claimed sums, a QM31 word a component) go to the
    lead as one (C, 4) copy, one cumulative sum over the shards gives every
    shard's carries, each shard after the first receives its C carries in
    one copy and launches one carry pass over its C last-entry blocks (the
    reference's cumulative sum across row shards, `build_interaction`
    under `_shard_dim`).  A claimed sum is its component's last shard's
    last row."""
    comps = list(comps)
    if mesh.size == 1:
        outs, claimed = kernels.air_witness_many(comps, ew)
        return list(zip(outs, claimed))
    out: List[Optional[tuple]] = [None] * len(comps)
    whole, sharded = [], []
    for i, (tp, main, pp) in enumerate(comps):
        if (list(main) + list(pp))[0].shape[0] < mesh.size:
            whole.append(i)
        elif tp.next_cols:
            raise ProverError(f"{tp.name}: a witness tape that reads the next row has no halo on row shards")
        else:
            sharded.append(i)
    if not sharded:
        outs, claimed = kernels.air_witness_many(comps, ew)
        return list(zip(outs, claimed))
    C = len(sharded)
    blocks: List[List[torch.Tensor]] = []  # [shard][component]: (4E, R)
    totals = torch.empty((mesh.size, C, 4), dtype=f.I32, device=mesh.lead)
    for r, (pos, dev) in enumerate(mesh.row_shards()):
        mine = []
        for i in sharded:
            tp, main, pp = comps[i]
            R = (list(main) + list(pp))[0].shape[0] // mesh.size
            cols = []
            for c in list(main) + list(pp):
                cols.append(c[r * R : (r + 1) * R].to(dev, non_blocking=True))
                count_bytes("scattered", 0, pos, cols[-1])
            mine.append((tp, cols[: len(main)], cols[len(main) :]))
        if r == 0:
            mine += [comps[i] for i in whole]
        with kernels.on_shard(pos):
            outs, claimed = kernels.air_witness_many(mine, ew)
        totals[r].copy_(claimed[:C], non_blocking=True)
        count_bytes("moved", pos, 0, claimed[:C])
        blocks.append(outs[:C])
        if r == 0:
            for k, i in enumerate(whole):
                out[i] = (outs[C + k], claimed[C + k])
    ends = (torch.cumsum(totals.to(f.I64), 0) % f.P).to(f.I32)  # each shard's end: the sum through it
    for r, (pos, dev) in enumerate(mesh.row_shards()):
        if r:
            carry = ends[r - 1].to(dev, non_blocking=True)
            count_bytes("moved", 0, pos, carry)
            with kernels.on_shard(pos):
                kernels.add_carry([b[-4:] for b in blocks[r]], carry)
    for k, i in enumerate(sharded):
        out[i] = (RowBlocks(mesh, [blocks[r][k] for r in range(mesh.size)]), ends[-1, k])
    return out


def _halo(x: RowBlocks, q: int, rows: slice, r: int, dev) -> torch.Tensor:
    part = x[q][rows]
    out = part.to(dev, non_blocking=True)
    count_bytes("moved", q, r, part)
    return out


def air_domain_many(mesh: Mesh, groups: List[tuple], ew) -> list:
    """K6 of every commit domain of a prove, one launch a row shard.
    groups: (terms, log_trace, stride) each, terms (tp, main, pp, inter,
    is_first, claimed, pows) of every component of that trace log, its
    columns either RowBlocks over the mesh's row shards (the committed
    trees' blocks, (R,) each) or whole on the lead (a trace of fewer rows
    than shards).  Returns each group's quotients: RowBlocks of (R, 4), or
    (M, 4) on the lead.

    Each shard's launch takes its block of every row-sharded domain, each
    component with its halo -- the next shard's first `stride` rows of
    each column read at the next row and the previous shard's last
    `stride` rows of the last relation entry, wrapping at the domain's
    ends (R at least `stride`) --, and the lead's the whole domains after
    them, so that a row-sharded domain has one index on every shard."""
    n = mesh.size
    blocks: List[list] = [[] for _ in range(n)]  # [shard]: its DomainBlocks of row-sharded domains
    lead = []  # the whole domains, after blocks[0]'s
    where = []  # per group: ("rows", index in each shard's list) or ("lead", index in `lead`)
    for terms, log_trace, stride in groups:
        if isinstance(terms[0][4], RowBlocks):
            R = terms[0][4][0].shape[0]
            if R < stride:
                raise ProverError(f"{terms[0][0].name}: a row block of {R} rows is smaller than its halo of {stride}")
            log_domain = n.bit_length() - 1 + R.bit_length() - 1
            for r, (pos, dev) in enumerate(mesh.row_shards()):
                mine = []
                for tp, main, pp, inter, is_first, claimed, pows in terms:
                    nxt = {x: _halo(main[x], (r + 1) % n, slice(0, stride), r, dev) for x in tp.next_cols}
                    prev = [_halo(c, (r - 1) % n, slice(R - stride, R), r, dev) for c in inter[-4:]]
                    mine.append(kernels.DomainTerm(tp, [c[r] for c in main], [c[r] for c in pp],
                                                   [c[r] for c in inter], is_first[r], claimed, pows, (nxt, prev)))
                blocks[r].append(kernels.DomainBlock(mine, log_trace, stride, r * R, log_domain))
            where.append(("rows", len(blocks[0]) - 1))
        else:
            terms = [kernels.DomainTerm(tp, [on_lead(c) for c in main], [on_lead(c) for c in pp],
                                        [on_lead(c) for c in inter], on_lead(is_first), claimed, pows)
                     for tp, main, pp, inter, is_first, claimed, pows in terms]
            lead.append(kernels.DomainBlock(terms, log_trace, stride))
            where.append(("lead", len(lead) - 1))
    n_rows = len(blocks[0])
    blocks[0] += lead
    outs = []
    for r, (pos, _) in enumerate(mesh.row_shards()):
        if blocks[r]:
            with kernels.on_shard(pos):
                outs.append(kernels.air_domain_many(blocks[r], ew))
    return [RowBlocks(mesh, [o[i] for o in outs], 0) if kind == "rows" else outs[0][n_rows + i] for kind, i in where]


def add_strided_coeffs(mesh: Mesh, acc: Optional[List[ColumnBlock]], q, stride: int, log: int) -> List[ColumnBlock]:
    """The composition's column work for a component smaller than the
    working domain D_log: its quotients' 4 coordinate columns (q: RowBlocks
    of (R, 4), or (M, 4) on the lead) on the column shards (`_col_blocks`),
    interpolated there (K1), added strided into `acc`, the column shards'
    (k, 2^log) coefficient blocks (zeros when None)."""
    cols = RowBlocks(mesh, [b.t() for b in q]) if isinstance(q, RowBlocks) else q.t()
    blocks = _col_blocks(mesh, cols)
    if acc is None:
        acc = [ColumnBlock(b.pos, b.c0, b.c1, torch.zeros((b.c1 - b.c0, 1 << log), dtype=f.I32,
                                                          device=b.evals.device), None) for b in blocks]
    for b, a in zip(blocks, acc):
        with kernels.on_shard(b.pos):
            coeffs = fft.ifft(b.evals)
        a.coeffs[:, ::stride] = f.add(a.coeffs[:, ::stride].to(f.I64), coeffs.to(f.I64)).to(f.I32)
    return acc


def add_coeff_evals(comp: RowBlocks, acc: List[ColumnBlock], log: int) -> RowBlocks:
    """comp (RowBlocks of (R, 4) on D_log) plus the evaluations of the
    coefficient blocks `acc` (K1 on each column shard, the block exchange
    to rows)."""
    for a in acc:
        with kernels.on_shard(a.pos):
            a.evals = fft.fft(a.coeffs)
    rows = _reshard(comp.mesh, acc, 4, log)
    return RowBlocks(comp.mesh, [f.add(c.to(f.I64), e.t().to(f.I64)).to(f.I32) for c, e in zip(comp, rows)], 0)


def down_commit(comp: RowBlocks, stride: int, log: int) -> RowBlocks:
    """The composition's evaluations on D_log (RowBlocks of (R, 4)) whose
    coefficients sit on the stride positions, evaluated on D_(log -
    log2(stride)) instead: on the column shards, K1's iFFT, the strided
    coefficients, K1's FFT; back to rows.  RowBlocks of (4, R')."""
    mesh = comp.mesh
    blocks = _col_blocks(mesh, RowBlocks(mesh, [b.t() for b in comp]))
    for b in blocks:
        with kernels.on_shard(b.pos):
            b.evals = fft.fft(fft.ifft(b.evals)[:, ::stride].contiguous())
    return RowBlocks(mesh, _reshard(mesh, blocks, 4, log - stride.bit_length() + 1))


def _logup_sum_body(mesh: Mesh, values: np.ndarray, mult: np.ndarray, z, alpha) -> torch.Tensor:
    """Row-parallel: logup_sum on each row shard's rows, one plan for all
    of them (kernels.LogupPlan), each shard's rows staged and copied
    (`_shard_rows`).  Each shard's (4,) partial goes into its row of one
    (S, 4) result on the lead: written there by the launch when the shard
    is on the lead's device, else copied in stream order.  One reduction
    sums them there (`lead_sum`): (4,) int32 on the lead."""
    plan = kernels.LogupPlan(z, alpha, values.shape[0])
    shards = [(pos, dev, a, b) for (pos, dev), (a, b) in zip(mesh.row_shards(),
                                                                split_evenly(values.shape[1], mesh.size)) if a < b]
    parts = torch.empty((len(shards), 4), dtype=f.I32, device=mesh.lead)
    for i, ((pos, dev, _, _), rows) in enumerate(zip(shards, _shard_rows(values, mult, shards))):
        with kernels.on_shard(pos):
            if dev == mesh.lead:
                plan(rows[:-1], rows[-1], parts[i])
            else:
                parts[i].copy_(plan(rows[:-1], rows[-1]), non_blocking=True)
    return lead_sum(parts)


def _shard_rows(values: np.ndarray, mult: np.ndarray, shards):
    """Each shard's relation rows with its multiplicities below them, a
    (K + 1, b - a) int32 block on its device, yielded in shard order: one
    host buffer (pinned when the shards are CUDA devices) holds every
    shard's block contiguous, filled by torch's copy (on all the host's
    threads; numpy's takes one), and each block is copied as soon as it is
    filled (asynchronous from pinned memory), so that one shard's copy
    and launch overlap the next one's fill."""
    k = values.shape[0]
    src, src_mult = torch.from_numpy(values.view(np.int32)), torch.from_numpy(mult.view(np.int32))
    stage = torch.empty((k + 1) * values.shape[1], dtype=f.I32, pin_memory=shards[0][1].type == "cuda")
    off = 0
    for _, dev, a, b in shards:
        block = stage[off : off + (k + 1) * (b - a)].view(k + 1, b - a)
        block[:k].copy_(src[:, a:b])
        block[k].copy_(src_mult[a:b])
        yield f.to_device(block, dev, non_blocking=True)
        off += block.numel()


def lead_sum(parts: torch.Tensor) -> torch.Tensor:
    """(4,) int32: the QM31 sum of the (S, 4) int32 rows of `parts` (M31
    words), one reduction mod P (S below 2^32)."""
    return (parts.to(f.I64).sum(0) % f.P).to(f.I32)


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
    commit = ShardedCommit(mesh, {log_n: cols}, log_blowup)
    commit.blocks.clear()  # the coefficients serve no OODS value here
    cl, tree = log_n + log_blowup, commit.tree
    # Enqueued before the evaluations' download, which waits for the card.
    claimed = _logup_sum_body(mesh, cols[:n_rel_cols], np.asarray(mult_m31, dtype=np.uint32), z, alpha)
    if isinstance(tree, ShardedMerkleTree):
        evals = np.concatenate([f.tensor_to_u32(t.cols_by_log[cl - tree.log_shards]) for t in tree.shards], axis=1)
    else:
        evals = f.tensor_to_u32(commit.evals[cl])
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
