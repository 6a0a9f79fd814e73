"""Circle FRI: commit, fold, decommit (prover) and replay, check
(verifier).

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

The commit chain runs on the card with no host sync (the reference's
accel.fri_commit_chain): the channel state is uploaded once; K8
(kernels.channel_draw_felt) draws alpha0; per committed layer, the pass of
the layer's tree (K2) that writes its root also mixes the root into the
channel and draws the layer's alpha into a record on the card (K8's step,
kernels.merkle_tree with the state and the layer's slot); one K3 launch
(kernels.fri_layer) then runs the layer's folds, reading its challenge
from that record and circle-folding the smaller inputs where they join;
the largest input's circle fold, layer 0, is a launch of its own.  One
download then brings the record -- final channel state, alpha0, every
root and alpha -- with the last layer.  The host channel, which stays
authoritative, replays the roots and must reach the same challenges and
state, or the prove raises ProverError.  The chain runs
down to the last layer: the reference's host tail below FUSED_MIN_ROWS is
a TPU-dispatch heuristic with the same transcript.

The verifier's half (`fri_replay`, `fri_check_queries`) runs on the host:
the transcript through the hashlib channel, the folds at the drawn queries
only, exact M31/QM31 arithmetic on int64 CPU tensors, the layers' Merkle
paths through hashlib (crypto/merkle.verify_decommitment), and the fold
twiddles of the queried positions alone (circle.domain_points_at).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import circle
from .. import fields as f
from .. import fft
from .. import kernels
from ..crypto.merkle import MerkleTree, ShardedMerkleTree, open_trees, verify_decommitment
from ..errors import ProverError
from ..parallel import sharding
from .config import FriConfig


def fold_circle_to_line(values: torch.Tensor, circle_log: int, alpha: torch.Tensor) -> torch.Tensor:
    """(2^circle_log, 4) on D_circle_log -> (N/2, 4) on its line domain:
    f(P) = E(x) + y*O(x), out = E + alpha*O.  alpha: 4 int32 words beside
    `values` (the challenge as K8 draws it).  A K3 launch of one fold with
    the 1/(2y) twiddles of the circle domain."""
    return kernels.fri_layer(values, [circle.twiddle_stage(circle_log, 0, True, values.device)], alpha)


def fold_layer(values: torch.Tensor, kmax: int, line_log: int, folds: int, alpha: torch.Tensor,
               alpha0: Optional[torch.Tensor], inputs: Dict[int, torch.Tensor], fold: int = 0) -> torch.Tensor:
    """`folds` line folds from (2^line_log, 4), one K3 launch for every
    kernels.FRI_MAX_FOLDS of them: fold t pairs (i, L-1-i) with the 1/(2x)
    twiddles of D_kmax's stage kmax - (line_log - t) and beta =
    alpha^(2^(fold + t)); where `inputs` has the circle log line_log - t,
    that input joins, circle-folded with alpha0 and scaled by beta^2."""
    dev = values.device
    twiddles = [circle.twiddle_stage(kmax, kmax - (line_log - t), True, dev) for t in range(folds)]
    mixes = [(inputs[line_log - t], circle.twiddle_stage(line_log - t, 0, True, dev)) if line_log - t in inputs
             else None for t in range(folds)]
    for t in range(0, folds, kernels.FRI_MAX_FOLDS):
        part = slice(t, t + kernels.FRI_MAX_FOLDS)
        values = kernels.fri_layer(values, twiddles[part], alpha, fold + t, mixes[part], alpha0)
    return values


def fold_line(values: torch.Tensor, kmax: int, line_log: int, alpha: torch.Tensor, fold: int = 0, mix=None,
              alpha0=None):
    """(2^line_log, 4) -> (2^(line_log-1), 4): a layer of one fold; `mix`, the
    FRI input of circle log line_log, joins circle-folded with alpha0."""
    return fold_layer(values, kmax, line_log, 1, alpha, alpha0, {line_log: mix} if mix is not None else {}, fold)


@dataclass
class FriProof:
    layer_roots: List[np.ndarray]
    layer_queried_values: List[List[np.ndarray]]  # per layer: 4 value arrays
    layer_witnesses: List[List[np.ndarray]]
    last_layer_coeffs: np.ndarray  # (2^D, 4) strided-extracted coefficients
    pow_nonce: int = 0


# The FRI record on the card: the channel state, alpha0, then a root and an
# alpha per committed layer (int32 words).
RECORD_HEAD = kernels.CHANNEL_WORDS + 4
LAYER_WORDS = 12


def layer_schedule(kmax: int, last_line_log: int, folds_per_layer: int):
    """[(line log, folds)] of each committed layer, from kmax - 1 down."""
    out, log = [], kmax - 1
    while log > last_line_log:
        folds = min(folds_per_layer, log - last_line_log)
        out.append((log, folds))
        log -= folds
    return out


def _mirror_runs(size_log: int, folds: int, a: int, m: int) -> List[List[int]]:
    """The rows a row block's folds read, as starts of runs of m rows: the
    block's output rows [a, a + m) after `folds` folds of a layer of
    2^size_log rows, and before fold t (runs[t], in the nested mirror
    order: fold t pairs rows (j, N_t - 1 - j), so the runs of level t are
    those of level t + 1, then their mirrors in reverse).  Laid out in that
    order on one shard, K3's own (i, N - 1 - i) pairing is the global
    one."""
    runs = [[a]]
    for t in range(folds - 1, -1, -1):
        size = 1 << (size_log - t)
        runs.insert(0, runs[0] + [size - st - m for st in reversed(runs[0])])
    return runs


def _assemble(src, starts: List[int], m: int, r: int, dev) -> torch.Tensor:
    """Rows [st, st + m) of `src` (RowBlocks of (R, 4)) for each start, in
    order, in one (len(starts) m, 4) buffer on `dev` (row shard r); each
    run lies in one block.  The runs from other positions count as moved."""
    R = src[0].shape[0]
    out = torch.empty((len(starts) * m, 4), dtype=f.I32, device=dev)
    for k, st in enumerate(starts):
        q, off = divmod(st, R)
        out[k * m : (k + 1) * m].copy_(src[q][off : off + m], non_blocking=True)
        sharding.count_bytes("moved", q, r, out[k * m : (k + 1) * m])
    return out


@functools.lru_cache(maxsize=512)
def _local_twiddles(log_size: int, stage: int, starts: tuple, m: int, dev: torch.device) -> torch.Tensor:
    """A stage's twiddles at the runs `starts` of m rows, in order, on
    `dev` (cached per shard)."""
    tw = circle.twiddle_stage(log_size, stage, True, dev)
    return torch.cat([tw[st : st + m] for st in starts])


def _fold_rows(src, size_log: int, twiddles: List[tuple], mixes: list, alphas: List[torch.Tensor], t0: int,
               alpha0s: Optional[List[torch.Tensor]]):
    """One K3 launch a row shard: len(twiddles) <= FRI_MAX_FOLDS folds of a
    layer of 2^size_log rows held as RowBlocks of (R, 4), into RowBlocks of
    the output.  Shard r assembles the rows its output block needs in
    nested mirror order (`_mirror_runs`) from up to 2^F shards, fold t's
    twiddles ((log, stage) of a twiddle table) and the joining input
    mixes[t] (RowBlocks, of 2^(size_log - t) rows) gathered the same way;
    alphas / alpha0s: each shard's copy of the challenges."""
    mesh = src.mesh
    F = len(twiddles)
    m = (1 << size_log) >> F >> (mesh.size.bit_length() - 1)
    out = []
    for r, (pos, dev) in enumerate(mesh.row_shards()):
        runs = _mirror_runs(size_log, F, r * m, m)
        tws = [_local_twiddles(log, stage, tuple(runs[t + 1]), m, f.device_key(dev))
               for t, (log, stage) in enumerate(twiddles)]
        mx = [None if x is None else (_assemble(x, runs[t], m, r, dev),
                                      _local_twiddles(size_log - t, 0, tuple(runs[t + 1]), m, f.device_key(dev)))
              for t, x in enumerate(mixes)]
        values = _assemble(src, runs[0], m, r, dev)
        with kernels.on_shard(pos):
            out.append(kernels.fri_layer(values, tws, alphas[r], t0, mx,
                                         alpha0s[r] if any(x is not None for x in mixes) else None))
    return sharding.RowBlocks(mesh, out, 0)


def fold_layer_rows(values, kmax: int, line_log: int, folds: int, alphas, alpha0s, inputs) -> "sharding.RowBlocks":
    """fold_layer on row shards (`_fold_rows`), one launch a shard for every
    kernels.FRI_MAX_FOLDS folds; the joining inputs are RowBlocks."""
    for t in range(0, folds, kernels.FRI_MAX_FOLDS):
        F = min(kernels.FRI_MAX_FOLDS, folds - t)
        size = line_log - t
        values = _fold_rows(values, size, [(kmax, kmax - (size - u)) for u in range(F)],
                            [inputs.get(size - u) for u in range(F)], alphas, t, alpha0s)
    return values


def commit_chain(inputs: Dict[int, torch.Tensor], last_line_log: int, folds_per_layer: int,
                 digest: bytes, counter: int):
    """The commit chain on the inputs' device from a channel state (digest,
    counter), ended by its one download.  Returns the chain's final
    (digest, counter), its roots and alphas, alpha0 (uint32 words), the
    last layer ((2^last_line_log, 4) int64 on the host) and the committed
    layers [(log, evals, MerkleTree)] (on the device).

    Inputs may be RowBlocks of (2^log / n, 4) over a mesh's n row shards
    (the others lie on its lead).  Then a layer stays row-sharded while its
    folds' output has at least a row per shard (so at least 2 n rows): its
    tree is a ShardedMerkleTree (K2 per shard, the top and K8's step on the
    lead), the alpha K8 writes there goes to each shard by a copy in stream
    order, and each shard folds its output block (`fold_layer_rows`, K3;
    the largest input's circle fold likewise).  The first layer below
    that, or the last layer, is gathered onto the lead, with any input
    that joins from there on, and the chain finishes there as on one
    device."""
    logs = sorted(inputs, reverse=True)
    kmax = logs[0]
    schedule = layer_schedule(kmax, last_line_log, folds_per_layer)
    mesh = next((x.mesh for x in inputs.values() if isinstance(x, sharding.RowBlocks)), None)
    dev = mesh.lead if mesh is not None else inputs[kmax].device
    n = mesh.size if mesh is not None else 1

    head = np.zeros(RECORD_HEAD + LAYER_WORDS * len(schedule), dtype=np.uint32)
    head[:8] = np.frombuffer(digest, dtype="<u4")
    head[8] = counter
    rec = f.u32_to_tensor(head, dev)  # the one upload
    state, alpha0 = rec[: kernels.CHANNEL_WORDS], rec[kernels.CHANNEL_WORDS : RECORD_HEAD]
    kernels.channel_draw_felt(state, alpha0)
    cur, alpha0s = inputs[kmax], None
    if isinstance(cur, sharding.RowBlocks) and 1 << (kmax - 1) >= n:
        alpha0s = sharding.to_shards(mesh, alpha0)
        cur = _fold_rows(cur, kmax, [(kmax, 0)], [None], alpha0s, 0, None)
    else:
        cur = fold_circle_to_line(sharding.on_lead(cur), kmax, alpha0)
    layers = []
    for i, (log, folds) in enumerate(schedule):
        slot = rec[RECORD_HEAD + LAYER_WORDS * i : RECORD_HEAD + LAYER_WORDS * (i + 1)]
        if isinstance(cur, sharding.RowBlocks) and 1 << (log - folds) >= n:
            tree = ShardedMerkleTree([{log: b.t()} for b in cur], {}, dev, state, slot)
            layers.append((log, cur, tree))
            cur = fold_layer_rows(cur, kmax, log, folds, sharding.to_shards(mesh, slot[8:]), alpha0s, inputs)
            continue
        cur = sharding.on_lead(cur)
        tree = MerkleTree({log: cur.t()}, state, slot)
        layers.append((log, cur, tree))
        joining = {l: sharding.on_lead(inputs[l]) for l in range(log - folds + 1, log + 1) if l in inputs}
        cur = fold_layer(cur, kmax, log, folds, slot[8:], alpha0, joining)
    cur = sharding.on_lead(cur)

    words = f.tensor_to_u32(torch.cat([rec, cur.reshape(-1)]))  # the one download
    slots = words[RECORD_HEAD : len(rec)].reshape(-1, LAYER_WORDS)
    return (
        words[:8].astype("<u4").tobytes(),
        int(words[8]),
        [s[:8].copy() for s in slots],
        [s[8:].copy() for s in slots],
        words[kernels.CHANNEL_WORDS : RECORD_HEAD].copy(),
        torch.from_numpy(words[len(rec) :].astype(np.int64)).reshape(-1, 4),
        layers,
    )


def _same(host: np.ndarray, device: np.ndarray, what: str) -> None:
    if not np.array_equal(np.asarray(host, dtype=np.uint32), device):
        raise ProverError(f"the channel on the device diverged from the host channel ({what})")


def fri_prove(inputs: Dict[int, torch.Tensor], config: FriConfig, channel):
    """inputs: {circle_log: (2^log, 4) int32 QM31 evaluations}.  Returns
    (FriProof without openings, context for `fri_decommit`)."""
    logs = sorted(inputs, reverse=True)
    if not logs:
        raise ProverError("no FRI inputs")
    kmax = logs[0]
    B = config.log_blowup_factor
    last_line_log = B + config.log_last_layer_degree_bound
    if min(logs) - 1 < last_line_log:
        raise ProverError("FRI last layer above the smallest input's line domain")
    F = max(1, int(config.folds_per_layer))
    digest, counter, roots, alphas, alpha0, last, layers = commit_chain(
        inputs, last_line_log, F, channel.digest, channel._counter
    )
    # The host channel replays the roots.
    _same(channel.draw_felt(), alpha0, "alpha0")
    for i, (root, alpha) in enumerate(zip(roots, alphas)):
        channel.mix_root(root)
        _same(channel.draw_felt(), alpha, f"the alpha of FRI layer {i}")
    if channel.digest != digest or channel._counter != counter:
        raise ProverError("the channel on the device diverged from the host channel (final state)")

    # Last layer: tiny -- interpolate on the host, extract strided coeffs.
    tw_line_inv = circle.ifft_twiddles(kmax)[kmax - last_line_log :]
    coeffs = fft.line_ifft_qm31(last, tw_line_inv)
    stride = 1 << B
    mask = torch.ones(len(coeffs), dtype=torch.bool)
    mask[::stride] = False
    if bool(torch.any(coeffs[mask] != 0)):
        raise ProverError("FRI last layer exceeds its degree bound")
    last_coeffs = f.tensor_to_u32(coeffs[::stride].contiguous())
    channel.mix_felts(last_coeffs)

    proof = FriProof(
        layer_roots=roots,
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


def _mirror(p: np.ndarray, n: int) -> np.ndarray:
    """The sorted distinct positions of p and their mirrors n - 1 - p."""
    return np.unique(np.concatenate([p, n - 1 - p]))


def fold_position_sets(pending, level_log: int, depth: int):
    """Position sets the verifier materialises when folding `depth` steps
    from carried positions `pending` at line level `level_log`:
    [S_0, ..., S_depth] (sorted int64 arrays), S_0 the full coset the
    committed layer opens."""
    final = np.unique(np.asarray(pending, dtype=np.int64))
    for t in range(depth):
        n = 1 << (level_log - t)
        final = np.unique(np.minimum(final, n - 1 - final))
    sets = [final]
    for t in range(depth, 0, -1):
        sets.append(_mirror(sets[-1], 1 << (level_log - t + 1)))
    sets.reverse()
    return sets


def _line_positions(positions, kmax: int) -> np.ndarray:
    """Drawn circle positions of D_kmax -> their line positions (kmax - 1)."""
    p = np.asarray(positions, dtype=np.int64)
    return np.unique(np.minimum(p, (1 << kmax) - 1 - p))


def fri_queries(ctx, positions) -> List[Dict[int, np.ndarray]]:
    """The query positions of each committed layer's tree, from the drawn
    positions: {log: the full coset the layer opens}."""
    pos = _line_positions(positions, ctx["kmax"])
    queries = []
    for (log, _evals, _tree) in ctx["layers"]:
        sets = fold_position_sets(pos, log, min(ctx["folds_per_layer"], log - ctx["last_line_log"]))
        queries.append({log: sets[0]})
        pos = sets[-1]
    return queries


def fill_openings(proof: FriProof, opened) -> FriProof:
    """Put the layers' (values, witness) of a decommitment pass in the proof."""
    for values, witness in opened:
        proof.layer_queried_values.append(values)
        proof.layer_witnesses.append(witness)
    return proof


def fri_decommit(proof: FriProof, ctx, positions: np.ndarray):
    """Fill the proof's per-layer openings for the drawn positions in one
    decommitment pass (the prover folds this pass into the trees')."""
    trees = [tree for _, _, tree in ctx["layers"]]
    return fill_openings(proof, open_trees(trees, fri_queries(ctx, positions)))


def needed_input_positions(drawn_positions, input_logs, fri_config) -> Dict[int, np.ndarray]:
    """For each input circle log, the positions (sorted int64 arrays) at
    which the verifier needs the FRI input (DEEP quotient) values -- the
    positions at which the committed columns of that commit log are
    opened."""
    logs = sorted({int(l) for l in input_logs}, reverse=True)
    kmax = logs[0]
    need = {kmax: _mirror(np.asarray(drawn_positions, dtype=np.int64), 1 << kmax)}
    pos = _line_positions(drawn_positions, kmax)
    F = max(1, int(fri_config.folds_per_layer))
    last_line_log = fri_config.log_blowup_factor + fri_config.log_last_layer_degree_bound
    cur_log = kmax - 1
    while cur_log > last_line_log:
        fl = min(F, cur_log - last_line_log)
        sets = fold_position_sets(pos, cur_log, fl)
        for t in range(1, fl + 1):
            k = cur_log - t + 1  # a circle-log-k input mixes at line level k-1
            if k in logs and k != kmax:
                need[k] = _mirror(sets[t], 1 << k)
        pos = sets[-1]
        cur_log -= fl
    return need


# ---------------------------------------------------------------------------
# Verifier.


def fri_replay(proof: FriProof, config: FriConfig, channel, input_logs: List[int]):
    """Replay the FRI transcript (roots, last-layer coefficients) on the
    channel; (alpha0, alphas) as uint32 words, or None on a structural
    mismatch."""
    logs = sorted(input_logs, reverse=True)
    kmax = logs[0]
    last_line_log = config.log_blowup_factor + config.log_last_layer_degree_bound
    # Soundness: the fold chain must reach every input's line level
    # (circle_log - 1).  input_logs come from the trusted claim and
    # settings, the config from the untrusted proof: with a last layer above
    # the smallest input's line level, that input would never join FRI and
    # its committed columns would stay unbound.
    if last_line_log > min(logs) - 1:
        return None

    F = max(1, int(config.folds_per_layer))
    alpha0 = channel.draw_felt()
    alphas = []
    cur_log = kmax - 1
    while cur_log > last_line_log:
        if len(alphas) >= len(proof.layer_roots):
            return None
        channel.mix_root(proof.layer_roots[len(alphas)])
        alphas.append(channel.draw_felt())
        cur_log -= min(F, cur_log - last_line_log)
    if len(proof.layer_roots) != len(alphas):
        return None
    if len(proof.last_layer_coeffs) != 1 << config.log_last_layer_degree_bound:
        return None
    channel.mix_felts(proof.last_layer_coeffs)
    return alpha0, alphas


def fri_verify(proof: FriProof, config: FriConfig, channel, query_eval_fn, input_logs: List[int], positions) -> bool:
    """Replay and check in one call (the PCS runs the two around the PoW
    and the query draw)."""
    replay = fri_replay(proof, config, channel, input_logs)
    if replay is None:
        return False
    alpha0, alphas = replay
    return fri_check_queries(proof, config, alpha0, alphas, query_eval_fn, input_logs, positions)


def line_twiddles_at(line_log: int, positions) -> torch.Tensor:
    """x of the line domain of size 2^line_log at `positions`: the x of
    rows `positions` of D_(line_log + 1) (int64)."""
    return circle.domain_points_at(line_log + 1, positions)[0]


def _fold(v_p: torch.Tensor, v_sib: torch.Tensor, twiddle: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """E + alpha O with E = (v_p + v_sib) / 2, O = (v_p - v_sib) / (2 t)."""
    e = f.mul(f.add(v_p, v_sib), f.INV2)
    o = f.qm31_mul_m31(f.mul(f.sub(v_p, v_sib), f.INV2), f.inv(twiddle))
    return f.add(e, f.qm31_mul(alpha, o))


def fri_check_queries(proof: FriProof, config: FriConfig, alpha0, alphas, query_eval_fn, input_logs: List[int],
                      positions) -> bool:
    """The FRI check at the drawn query positions.

    query_eval_fn(circle_log, positions) -> (k, 4) QM31 values of the FRI
    input (the verifier's DEEP quotients) at an int64 position array.  Per
    committed layer: its opening's Merkle path, the carried values against
    the opened ones, then its folds at the positions they reach, smaller
    inputs joining scaled by the square of the fold's challenge; at the
    end, the carried values against the last layer's polynomial."""
    logs = sorted(input_logs, reverse=True)
    kmax = logs[0]
    B = config.log_blowup_factor
    last_line_log = B + config.log_last_layer_degree_bound
    alpha0 = f.host_i64(alpha0)

    def circle_fold_at(circle_log, pos):
        n = 1 << circle_log
        i = np.minimum(pos, n - 1 - pos)
        v_i = f.host_i64(query_eval_fn(circle_log, i))
        v_sib = f.host_i64(query_eval_fn(circle_log, n - 1 - i))
        return _fold(v_i, v_sib, circle.domain_points_at(circle_log, i)[1], alpha0)

    def lookup(sorted_pos, vals, targets):
        """The rows of `vals` at `targets`; None if one is not opened."""
        idx = np.searchsorted(sorted_pos, targets)
        if np.any(idx >= len(sorted_pos)) or np.any(sorted_pos[np.minimum(idx, len(sorted_pos) - 1)] != targets):
            return None
        return vals[torch.from_numpy(idx)]

    n0 = 1 << kmax
    pos = np.asarray(positions, dtype=np.int64)
    pend_pos = np.unique(np.minimum(pos, n0 - 1 - pos))  # line level kmax - 1
    pend_vals = circle_fold_at(kmax, pend_pos)

    cur_line_log = kmax - 1
    F = max(1, int(config.folds_per_layer))
    layer = 0
    while cur_line_log > last_line_log:
        log = cur_line_log
        folds = min(F, log - last_line_log)
        sets = fold_position_sets(pend_pos, log, folds)
        vals, wit = proof.layer_queried_values[layer], proof.layer_witnesses[layer]
        if not verify_decommitment(proof.layer_roots[layer], [log] * 4, {log: sets[0]}, vals, wit):
            return False
        cur_pos = sets[0]
        cur_vals = torch.stack([f.host_i64(vals[c]) for c in range(4)], dim=-1)
        carried = lookup(cur_pos, cur_vals, pend_pos)
        if carried is None or not torch.equal(carried, pend_vals):
            return False
        beta = f.host_i64(alphas[layer])
        for t in range(folds):
            lvl = log - t  # the level folded, of size 2^lvl
            nxt_pos = sets[t + 1]
            v_p = lookup(cur_pos, cur_vals, nxt_pos)
            v_sib = lookup(cur_pos, cur_vals, (1 << lvl) - 1 - nxt_pos)
            if v_p is None or v_sib is None:
                return False
            # Swapping p and its sibling negates both the numerator and the
            # x twiddle, so p's own x serves.
            cur_vals = _fold(v_p, v_sib, line_twiddles_at(lvl, nxt_pos), beta)
            cur_pos = nxt_pos
            # An input of circle log lvl joins at line level lvl - 1,
            # scaled by the square of the challenge just applied.
            if lvl in logs and lvl != kmax:
                cur_vals = f.add(cur_vals, f.qm31_mul(f.qm31_mul(beta, beta), circle_fold_at(lvl, cur_pos)))
            beta = f.qm31_mul(beta, beta)
        pend_pos, pend_vals = cur_pos, cur_vals
        cur_line_log -= folds
        layer += 1

    # The last layer: its strided coefficients at the carried positions.
    coeffs = torch.zeros((1 << last_line_log, 4), dtype=f.I64)
    coeffs[:: 1 << B] = f.host_i64(proof.last_layer_coeffs)
    expect = fft.line_eval_at_x(coeffs, line_twiddles_at(last_line_log, pend_pos))
    return bool(torch.equal(expect, pend_vals))
