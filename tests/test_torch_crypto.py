"""Blake2s, Merkle trees and the channel of luminair_tpu_torch against
hashlib and luminair_tpu.crypto."""

import hashlib

import numpy as np
import pytest
import torch

from luminair_tpu.crypto import blake2s as ref_blake2s
from luminair_tpu.crypto import channel as ref_channel
from luminair_tpu.crypto import merkle as ref_merkle
from luminair_tpu_torch import fields as f
from luminair_tpu_torch.crypto import blake2s, channel
from luminair_tpu_torch.crypto.merkle import MerkleTree, gather_many


def _words(seed, shape):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << 32, size=shape, dtype=np.uint64).astype(np.uint32)


@pytest.mark.parametrize("L", [8, 16, 23, 31, 40])
def test_hash_words(L):
    w = _words(L, (37, L))
    out = f.tensor_to_u32(blake2s.hash_words(f.u32_to_tensor(w)))
    for i in range(len(w)):
        expect = np.frombuffer(hashlib.blake2s(w[i].astype("<u4").tobytes()).digest(), dtype="<u4")
        assert np.array_equal(out[i], expect)
    # the reference's vectorised path (above its hashlib cut-off)
    big = _words(L + 1, (1100, L))
    assert np.array_equal(
        f.tensor_to_u32(blake2s.hash_words(f.u32_to_tensor(big))), ref_blake2s.hash_words(big)
    )


def _mixed_columns(seed, logs):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, (1 << 31) - 1, size=1 << log, dtype=np.int64).astype(np.uint32) for log in logs]


def _port_tree(cols):
    by_log = {}
    for c in cols:
        by_log.setdefault(len(c).bit_length() - 1, []).append(c)
    return MerkleTree({log: f.u32_to_tensor(np.stack(cs)) for log, cs in by_log.items()})


@pytest.mark.parametrize(
    "logs,queries",
    [
        ([5], {5: [0, 7, 31]}),
        ([6, 6, 4, 4, 4, 2], {6: [1, 2, 40, 63], 4: [3, 9]}),
        ([3, 7, 5, 7], {7: [0, 127], 5: [11], 3: [2]}),
    ],
)
def test_merkle_root_and_openings(logs, queries):
    cols = _mixed_columns(len(logs), logs)
    ref = ref_merkle.MerkleTree(cols)
    port = _port_tree(cols)
    assert np.array_equal(port.root, ref.root)
    q_specs, q_asm = port.queried_values_plan(queries)
    d_specs, d_asm = port.decommit_plan(queries)
    res = gather_many(q_specs + d_specs)
    values = q_asm(res[: len(q_specs)])
    witness = d_asm(res[len(q_specs) :])
    ref_values = ref.queried_values(queries)
    ref_witness = ref.decommit(queries)
    assert len(values) == len(ref_values) and len(witness) == len(ref_witness)
    for a, b in zip(values, ref_values):
        assert np.array_equal(a, b)
    for a, b in zip(witness, ref_witness):
        assert np.array_equal(a, b)
    assert ref_merkle.verify_decommitment(port.root, logs, queries, values, witness)


def test_merkle_strided_qm31_layer():
    """A FRI layer commits the transposed (N, 4) QM31 array as 4 columns."""
    v = _words(3, (64, 4)) & np.uint32((1 << 31) - 1)
    ref = ref_merkle.MerkleTree([np.ascontiguousarray(v[:, k]) for k in range(4)])
    port = MerkleTree({6: f.u32_to_tensor(v).t()})
    assert np.array_equal(port.root, ref.root)


def test_channel_transcript():
    port, ref = channel.Blake2sChannel(), ref_channel.Blake2sChannel()
    for ch in (port, ref):
        ch.mix_u32s([1, 2, 3])
        ch.mix_root(np.arange(8, dtype=np.uint32))
        ch.mix_felts(np.arange(12, dtype=np.uint32).reshape(3, 4))
        ch.mix_u64(99)
    assert np.array_equal(port.draw_felt(), ref.draw_felt())
    assert np.array_equal(port.draw_base_felts(9), ref.draw_base_felts(9))
    assert np.array_equal(port.draw_queries(15, 12), ref.draw_queries(15, 12))
    for bits in (0, 3, 9):
        assert port.grind_pow(bits) == ref.grind_pow(bits)
    assert port.digest == ref.digest


def test_merkle_layer_plain_on_cpu_is_the_wrapper_path():
    cols = torch.arange(24, dtype=torch.int32).reshape(3, 8)
    from luminair_tpu_torch import kernels

    before = kernels.MERKLE.launches
    assert torch.equal(kernels.merkle_layer(None, cols), kernels.merkle_layer_plain(None, cols))
    assert kernels.MERKLE.launches == before  # CPU tensors launch nothing
