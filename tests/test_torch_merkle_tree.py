"""K2, the whole Merkle tree (csrc/merkle.cu): the pass plan, the plain twin
against the reference's MerkleTree, and csrc/merkle.cuh built with g++ and
run on the CPU, one CTA after another, at several tile sizes against the
twin; with K8's channel step in the root pass against the reference's
host channel, and the FRI commit chain through that build against the
reference's device chain (luminair_tpu.parallel.accel on JAX's CPU)."""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from luminair_tpu.crypto import merkle as ref_merkle
from luminair_tpu.crypto.channel import Blake2sChannel as RefChannel
from luminair_tpu.parallel import accel
from luminair_tpu_torch import fields as f
from luminair_tpu_torch import kernels
from luminair_tpu_torch.crypto.merkle import MerkleTree
from luminair_tpu_torch.pcs import fri

P = (1 << 31) - 1


@pytest.mark.parametrize("tile_log", range(12))
def test_pass_plan_hashes_every_layer_once(tile_log):
    for bottom in range(25):
        passes = kernels.merkle_passes(bottom, tile_log)
        layers = [b - j for b in passes for j in range(min(b, tile_log) + 1)]
        assert layers == list(range(bottom, -1, -1))
        assert len(passes) == -(-(bottom + 1) // (tile_log + 1))


def _signature(rng, logs, fri=False):
    """The same columns as a reference tree's column list and as the
    port's {log: (k, 2^log) view}; a FRI layer commits the transposed
    (2^log, 4) QM31 array."""
    if fri:
        v = rng.integers(0, P, size=(1 << logs[0], 4), dtype=np.int64).astype(np.uint32)
        return [np.ascontiguousarray(v[:, k]) for k in range(4)], {logs[0]: f.u32_to_tensor(v).t()}
    cols = [rng.integers(0, P, size=1 << log, dtype=np.int64).astype(np.uint32) for log in logs]
    by_log = {}
    for c in cols:
        by_log.setdefault(len(c).bit_length() - 1, []).append(c)
    return cols, {log: f.u32_to_tensor(np.stack(cs)) for log, cs in by_log.items()}


# Column logs of a tree (a log inside a tile carries columns in most), or
# ("fri", log).  Bottom logs 0, 2, 3, 4, 5, 7, 9 and 12 sit at t - 1, t,
# t + 1 and 2t + 1 of the tile logs below.
SIGNATURES = {
    "one leaf": [0],
    "one leaf, three columns": [0, 0, 0],
    "bottom 2": [2, 1, 1, 0],
    "bottom 3": [3, 3, 2, 1],
    "bottom 4, 40 columns at 3": [4] + [3] * 40,
    "bottom 5": [5, 5, 4, 2, 0],
    "bottom 7, columns every other log": [7, 7, 5, 3, 1],
    "bottom 9": [9, 8, 8, 6, 4],
    "bottom 12": [12, 12, 12, 11, 6, 6],
    "fri 7": ("fri", 7),
    "fri 10": ("fri", 10),
}


def _case(name):
    rng = np.random.default_rng(sorted(SIGNATURES).index(name))
    spec = SIGNATURES[name]
    return _signature(rng, [spec[1]], fri=True) if spec[0] == "fri" else _signature(rng, spec)


def _fresh(cols_by_log):
    bottom = max(cols_by_log)
    return kernels.TreeDesc(kernels.tree_layers(bottom, "cpu"), cols_by_log)


@pytest.mark.parametrize("name", sorted(SIGNATURES))
def test_twin_equals_reference(name):
    ref_cols, cols_by_log = _case(name)
    ref = ref_merkle.MerkleTree(ref_cols)
    port = MerkleTree(cols_by_log)
    assert sorted(port.layers) == list(range(ref.max_log + 1))
    for log, layer in port.layers.items():
        assert np.array_equal(f.tensor_to_u32(layer), np.asarray(ref.layers[log], dtype=np.uint32)), log
    assert np.array_equal(port.root, ref.root)


def test_tree_layers_are_views_of_one_buffer():
    layers = kernels.tree_layers(5, "cpu")
    base = layers[0].untyped_storage().data_ptr()
    for log, layer in layers.items():
        assert layer.shape == (1 << log, 8) and layer.is_contiguous()
        assert layer.untyped_storage().data_ptr() == base
        assert layer.data_ptr() == base + 32 * ((1 << log) - 1)


# ---------------------------------------------------------------------------
# csrc/merkle.cuh on the CPU.

_SHIM = r"""
#include <vector>
#define __host__
#define __device__
#define __forceinline__ inline
#include "merkle.cuh"
struct HostBlock {
  int tid() const { return 0; }
  int threads() const { return 1; }
  void sync() const {}
};
extern "C" long long h_pass_size() { return sizeof(lum::MerklePass); }
extern "C" void h_merkle_pass(lum::MerklePass p) {
  std::vector<uint32_t> sm(lum::merkle_smem_words(lum::merkle_tile(p)));
  for (long long c = 0; c < lum::merkle_ctas(p); c++) {
    if (p.state)
      lum::merkle_cta<HostBlock, true>(HostBlock{}, p, c, sm.data());
    else
      lum::merkle_cta(HostBlock{}, p, c, sm.data());
  }
}
"""


def _header():
    return (Path(kernels.__file__).resolve().parent / "csrc" / "merkle.cuh").read_text()


def _build(d: Path, header: str):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no C++ compiler for the host build of csrc/merkle.cuh")
    csrc = Path(kernels.__file__).resolve().parent / "csrc"
    (d / "merkle.cuh").write_text(header)
    for name in ("blake2s.cuh", "channel.cuh"):
        (d / name).write_text((csrc / name).read_text())
    (d / "shim.cpp").write_text(_SHIM)
    subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-I", str(d), "-o", str(d / "merkle.so"),
                    str(d / "shim.cpp")], check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(d / "merkle.so"))
    lib.h_pass_size.restype = ctypes.c_longlong
    assert lib.h_pass_size() == ctypes.sizeof(kernels.MerklePass)
    lib.h_merkle_pass.argtypes = [kernels.MerklePass]
    return lib


@pytest.fixture(scope="module")
def host_merkle(tmp_path_factory):
    return _build(tmp_path_factory.mktemp("merkle"), _header())


def _host_tree(lib, cols_by_log, tile_log, state=None, slot=None):
    """The tree through the header's passes (with a channel: K8's step in
    the root pass); {log: layer}."""
    desc = _fresh(cols_by_log)
    for layer in desc.layers.values():
        layer.fill_(-1)  # every word must be written by a pass
    kernels._merkle_launch(desc, tile_log, lib.h_merkle_pass, state, slot)
    return desc.layers


def _plain_tree(cols_by_log):
    desc = _fresh(cols_by_log)
    kernels.merkle_tree_plain(desc)
    return desc.layers


@pytest.mark.parametrize("tile_log", [1, 2, 3, 4])
@pytest.mark.parametrize("name", sorted(SIGNATURES))
def test_header_passes_equal_twin(host_merkle, name, tile_log):
    _, cols_by_log = _case(name)
    got, want = _host_tree(host_merkle, cols_by_log, tile_log), _plain_tree(cols_by_log)
    for log in want:
        assert torch.equal(got[log], want[log]), log


def test_header_at_the_card_tile(host_merkle):
    """The card's tile (2^10 nodes) on a tree of 2^12 leaves with columns at
    logs inside the first tile and in the last pass."""
    _, cols_by_log = _case("bottom 12")
    got, want = _host_tree(host_merkle, cols_by_log, kernels.MERKLE_TILE_LOG), _plain_tree(cols_by_log)
    assert all(torch.equal(got[log], want[log]) for log in want)


# ---------------------------------------------------------------------------
# K8's channel step in the root pass.


def _channel(seed):
    """A random channel state (digest, counter, alpha) and a record slot."""
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 32, size=kernels.CHANNEL_WORDS, dtype=np.uint64).astype(np.uint32)
    words[8] = rng.integers(0, 300)
    return f.u32_to_tensor(words), torch.full((12,), -1, dtype=torch.int32)


def _ref_step(state, root):
    """The reference's host channel from `state`: mix_root(root), draw_felt()."""
    words = f.tensor_to_u32(state)
    ch = RefChannel()
    ch.digest, ch._counter = words[:8].astype("<u4").tobytes(), int(words[8])
    ch.mix_root(root)
    alpha = ch.draw_felt()
    return np.concatenate([np.frombuffer(ch.digest, dtype="<u4"), [ch._counter], alpha]).astype(np.uint32), alpha


# FRI layers' trees of logs 0-12: one pass at every log at the card's tile
# (2^10), two passes from log 11; at a tile of 2^2 the root pass comes after
# one to four others.
@pytest.mark.parametrize("tile_log", [2, kernels.MERKLE_TILE_LOG])
@pytest.mark.parametrize("log", range(13))
def test_header_channel_step_equals_reference(host_merkle, log, tile_log):
    rng = np.random.default_rng(1000 + log)
    v = rng.integers(0, P, size=(1 << log, 4), dtype=np.int64).astype(np.uint32)
    cols = {log: f.u32_to_tensor(v).t()}
    state, slot = _channel(log + 50 * tile_log)
    want_state, want_alpha = _ref_step(state, ref_merkle.MerkleTree([np.ascontiguousarray(v[:, k])
                                                                      for k in range(4)]).root)
    got = _host_tree(host_merkle, cols, tile_log, state, slot)
    plain = _plain_tree(cols)
    assert all(torch.equal(got[l], plain[l]) for l in plain)  # the tree is the tree without the step
    assert np.array_equal(f.tensor_to_u32(state), want_state)
    assert np.array_equal(f.tensor_to_u32(slot), np.concatenate([f.tensor_to_u32(plain[0][0]), want_alpha]))


def test_twin_channel_step_equals_reference():
    """merkle_tree with a channel on CPU tensors: the plain tree, then the
    plain step (channel_mix_root_draw_plain)."""
    for log in (0, 5, 11):
        cols = {log: f.u32_to_tensor(np.random.default_rng(log).integers(0, P, size=(3, 1 << log)).astype(np.uint32))}
        state, slot = _channel(log)
        want_state, want_alpha = _ref_step(state, MerkleTree(cols).root)
        tree = MerkleTree(cols, state, slot)
        assert np.array_equal(f.tensor_to_u32(state), want_state)
        assert np.array_equal(f.tensor_to_u32(slot), np.concatenate([tree.root, want_alpha]))


# The chains of tests/test_torch_channel.py (input logs, folds a layer),
# every FRI layer's tree and channel step through the host build (at a tile
# of 2^2: roots after several passes; at the card's, one pass a tree).
CHAINS = [((8, 7, 5), 1), ((8, 7, 5), 2), ((8, 7, 5), 3), ((8, 6, 5, 4), 2), ((8, 6, 5, 4), 3)]


@pytest.mark.parametrize("tile_log", [2, kernels.MERKLE_TILE_LOG])
@pytest.mark.parametrize("logs,folds", CHAINS)
def test_commit_chain_through_header_matches_reference(host_merkle, monkeypatch, logs, folds, tile_log):
    rng = np.random.default_rng(sum(logs) + folds)
    inputs = {k: rng.integers(0, P, size=(1 << k, 4), dtype=np.int64).astype(np.uint32) for k in logs}
    B, bound = 1, 2
    digest = rng.integers(0, 1 << 32, 8, dtype=np.uint64).astype("<u4").tobytes()
    ref = accel.fri_commit_chain(inputs, B, bound, folds, B + bound, digest, 3)
    steps = []

    def tree(desc, state=None, slot=None):
        steps.append(state is not None)
        kernels._merkle_launch(desc, tile_log, host_merkle.h_merkle_pass, state, slot)

    monkeypatch.setattr(kernels, "merkle_tree", tree)
    monkeypatch.setattr(kernels, "channel_mix_root_draw_plain", None)  # the step runs in the header alone
    got = fri.commit_chain({k: f.u32_to_tensor(v) for k, v in inputs.items()}, B + bound, folds, digest, 3)
    assert steps == [True] * len(fri.layer_schedule(max(logs), B + bound, folds))
    assert got[0] == ref[0] and got[1] == ref[1]
    assert len(got[2]) == len(ref[2]) == len(steps)
    for a, b in zip(got[2] + got[3], ref[2] + ref[3]):
        assert np.array_equal(a, np.asarray(b, dtype=np.uint32))
    assert np.array_equal(got[4], ref[4])
    assert np.array_equal(f.tensor_to_u32(got[5]), ref[5])


# Mutations the twin must catch: the byte counter of a message's last
# block or of an earlier block, the two children read in swapped order; in
# the channel step, the step on a layer other than the root's, and the
# counter written where the alpha goes.
@pytest.mark.parametrize("mutation", [
    ("last ? (uint32_t)(4 * len)", "last ? (uint32_t)(4 * k)"),
    (": (uint32_t)(64 * (blk + 1))", ": (uint32_t)(64 * blk)"),
    ("for (int w = 0; w < 16; w++) m[w] = kids[w];", "for (int w = 0; w < 16; w++) m[w] = kids[w ^ 8];"),
    ("if (l == 0) {  // the root", "if (l == 1) {  // the root"),
    ("slot[8 + k] = chan[CH_ALPHA + k];", "slot[8 + k] = chan[CH_COUNTER + k];"),
])
def test_mutated_header_fails(tmp_path, mutation):
    old, new = mutation
    header = _header()
    assert header.count(old) == 1
    lib = _build(tmp_path, header.replace(old, new))
    _, cols_by_log = _case("bottom 9")
    state, slot = _channel(9)
    want_state, want_slot = state.clone(), slot.clone()
    kernels.merkle_tree(_fresh(cols_by_log), want_state, want_slot)
    got, want = _host_tree(lib, cols_by_log, 3, state, slot), _plain_tree(cols_by_log)
    assert not (all(torch.equal(got[log], want[log]) for log in want) and torch.equal(state, want_state)
                and torch.equal(slot, want_slot))
