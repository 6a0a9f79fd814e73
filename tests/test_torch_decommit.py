"""K9, the decommitment pass (csrc/decommit.cu): its plain twin against the
reference's MerkleTree.decommit / queried_values, the host plan's checks,
and csrc/decommit.cuh built with g++ and run on the CPU, one CTA after
another, against the twin."""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

from luminair_tpu.crypto import merkle as ref_merkle
from luminair_tpu_torch import fields as f
from luminair_tpu_torch import kernels
from luminair_tpu_torch.crypto.merkle import MerkleTree, open_trees
from luminair_tpu_torch.errors import KernelError

P = (1 << 31) - 1


def _cols(rng, logs):
    return [rng.integers(0, P, size=1 << log, dtype=np.int64).astype(np.uint32) for log in logs]


def _trees(rng, logs):
    """The same columns as a reference tree and as a port tree."""
    cols = _cols(rng, logs)
    by_log = {}
    for c in cols:
        by_log.setdefault(len(c).bit_length() - 1, []).append(c)
    return ref_merkle.MerkleTree(cols), MerkleTree({log: f.u32_to_tensor(np.stack(cs)) for log, cs in by_log.items()})


def _fri_layer(rng, log):
    """A FRI layer: the (2^log, 4) QM31 evaluations committed through their
    transposed (4, 2^log) view."""
    v = rng.integers(0, P, size=(1 << log, 4), dtype=np.int64).astype(np.uint32)
    return ref_merkle.MerkleTree([np.ascontiguousarray(v[:, k]) for k in range(4)]), MerkleTree(
        {log: f.u32_to_tensor(v).t()})


# (column logs, {log: queries}) per tree; all trees of a case open in one pass.
CASES = {
    "mixed sizes, queries at several logs": [
        ([8, 8, 6, 6, 6, 3], {8: [1, 2, 100, 255], 6: [0, 9, 63], 3: [5]}),
        ([7, 5, 7], {7: [0, 127], 5: [11]}),
    ],
    "edges and adjacent siblings": [([6, 6, 4], {6: [0, 1, 2, 3, 62, 63], 4: [0, 15]})],
    "a log without queries": [([9, 7, 5, 5], {9: [17, 300], 5: [4, 5]})],
    "one column": [([5], {5: [0, 7, 31]})],
    "no queries at all": [([4, 2], {}), ([5], {5: [3]})],
    "a FRI layer": [("fri", 7, {7: [0, 1, 64, 127]})],
    "dense": [([5, 4, 3], {5: list(range(0, 32, 2)), 4: list(range(16)), 3: [7]})],
}


def _case(name):
    rng = np.random.default_rng(sorted(CASES).index(name))
    refs, ports, queries = [], [], []
    for spec in CASES[name]:
        if spec[0] == "fri":
            ref, port = _fri_layer(rng, spec[1])
        else:
            ref, port = _trees(rng, spec[0])
        refs.append(ref)
        ports.append(port)
        queries.append(spec[-1])
    return refs, ports, queries


def _np_queries(queries):
    return [{log: np.array(pos, dtype=np.int64) for log, pos in q.items()} for q in queries]


@pytest.mark.parametrize("name", sorted(CASES))
def test_twin_equals_reference(name):
    refs, ports, queries = _case(name)
    opened = open_trees(ports, _np_queries(queries))
    for ref, q, (values, witness) in zip(refs, queries, opened):
        ref_values, ref_witness = ref.queried_values(q), ref.decommit(q)
        assert len(values) == len(ref_values)
        for a, b in zip(values, ref_values):
            assert np.array_equal(a, np.asarray(b, dtype=np.uint32))
        assert witness.shape == (len(ref_witness), 8)
        assert np.array_equal(witness, np.asarray(ref_witness, dtype=np.uint32).reshape(-1, 8))


def test_bounds_hold_the_output():
    """The host's bounds are upper bounds of what each tree writes: the
    twin's counts fit them, and the header gives the counts."""
    for name in CASES:
        _, ports, queries = _case(name)
        plan = kernels.DecommitPass([t.desc for t in ports], _np_queries(queries))
        words = f.tensor_to_u32(kernels.decommit_plain(plan))
        for tree, (hdr, wit, val, L) in zip(plan.trees, plan.region):
            h = words[hdr : hdr + 2 * (L + 1)].reshape(-1, 2).astype(np.int64)
            assert (h[:, 0] <= plan.cap).all() and (h[:, 1] <= plan.cap).all()
            assert wit + 8 * h[:, 1].sum() <= val


def test_out_of_range_and_unsorted_queries_raise():
    _, ports, _ = _case("one column")
    desc = ports[0].desc
    for bad in ({5: np.array([32])}, {5: np.array([-1])}, {5: np.array([3, 2])}, {5: np.array([4, 4])},
                {6: np.array([0])}):
        with pytest.raises(KernelError):
            kernels.DecommitPass([desc], [bad])


# ---------------------------------------------------------------------------
# csrc/decommit.cuh on the CPU.

_SHIM = r"""
#include <vector>
#define __host__
#define __device__
#define __forceinline__ inline
#include "decommit.cuh"
struct HostBlock {
  int tid() const { return 0; }
  int threads() const { return 1; }
  void sync() const {}
  int exclusive_scan(int v, int& total) const { total = v; return 0; }
};
extern "C" long long h_tree_words() { return lum::DC_TREE_WORDS; }
extern "C" long long h_desc_words() { return lum::DC_DESC_WORDS; }
extern "C" void h_decommit(const long long* pass, int n_trees, int n_slices, int cap, int32_t* out) {
  std::vector<int32_t> sm(3 * (long long)cap);
  for (int t = 0; t < n_trees; t++)
    for (int s = 0; s < n_slices; s++)
      lum::dc_tree(HostBlock{}, pass + (long long)t * lum::DC_TREE_WORDS, pass + (long long)n_trees * lum::DC_TREE_WORDS,
                   out, s, n_slices, cap, sm.data());
}
"""


@pytest.fixture(scope="module")
def host_decommit(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no C++ compiler for the host build of csrc/decommit.cuh")
    d = tmp_path_factory.mktemp("decommit")
    (d / "shim.cpp").write_text(_SHIM)
    csrc = Path(kernels.__file__).resolve().parent / "csrc"
    subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-I", str(csrc), "-o", str(d / "dc.so"),
                    str(d / "shim.cpp")], check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(d / "dc.so"))
    for name, want in (("h_tree_words", kernels.DC_TREE_WORDS), ("h_desc_words", kernels.DC_DESC_WORDS)):
        getattr(lib, name).restype = ctypes.c_longlong
        assert getattr(lib, name)() == want
    lib.h_decommit.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    return lib


@pytest.mark.parametrize("slices", [None, 3])
@pytest.mark.parametrize("name", sorted(CASES))
def test_header_walk_equals_twin(host_decommit, name, slices):
    """The kernel's per-tree walk (sets, scans, gathers), run here over the
    plan's packed upload through the trees' addresses: the twin's words."""
    _, ports, queries = _case(name)
    plan = kernels.DecommitPass([t.desc for t in ports], _np_queries(queries))
    packed = np.ascontiguousarray(plan.packed)
    out = np.zeros(plan.n_words, dtype=np.int32)
    host_decommit.h_decommit(packed.ctypes.data_as(ctypes.c_void_p), len(ports), slices or plan.slices, plan.cap,
                             out.ctypes.data_as(ctypes.c_void_p))
    assert np.array_equal(out, kernels.decommit_plain(plan).numpy())


def test_header_walk_on_random_passes(host_decommit):
    """Random trees and queries at random logs, several per pass."""
    rng = np.random.default_rng(11)
    for _ in range(6):
        ports, queries = [], []
        for _ in range(int(rng.integers(1, 4))):
            bottom = int(rng.integers(1, 11))
            logs = sorted({bottom} | set(rng.integers(0, bottom + 1, 3).tolist()), reverse=True)
            ports.append(_trees(rng, logs)[1])
            q = {}
            for log in logs:
                if rng.random() < 0.8:
                    q[log] = np.unique(rng.integers(0, 1 << log, int(rng.integers(1, 12))))
            queries.append(q)
        plan = kernels.DecommitPass([t.desc for t in ports], queries)
        packed = np.ascontiguousarray(plan.packed)
        out = np.zeros(plan.n_words, dtype=np.int32)
        host_decommit.h_decommit(packed.ctypes.data_as(ctypes.c_void_p), len(ports), 2, plan.cap,
                                 out.ctypes.data_as(ctypes.c_void_p))
        assert np.array_equal(out, kernels.decommit_plain(plan).numpy())


def _above_old_cap():
    """A tree of 3 columns at 2^14 and 2 at 2^13, every position queried at
    both logs: the merge at log 13 holds 2^14 + 2 * 2^13 = 32,768 positions,
    above the 17,066 that fit in a CTA's shared memory."""
    rng = np.random.default_rng(14)
    ref, port = _trees(rng, [14, 14, 14, 13, 13])
    return ref, port, {14: np.arange(1 << 14), 13: np.arange(1 << 13)}


def test_pass_above_shared_memory_equals_reference():
    ref, port, queries = _above_old_cap()
    plan = kernels.DecommitPass([port.desc], [queries])
    assert 3 * plan.cap * 4 > 200 * 1024
    ((values, witness),) = open_trees([port], [queries])
    q = {log: pos.tolist() for log, pos in queries.items()}
    ref_values, ref_witness = ref.queried_values(q), ref.decommit(q)
    assert len(values) == len(ref_values)
    for a, b in zip(values, ref_values):
        assert np.array_equal(a, np.asarray(b, dtype=np.uint32))
    assert witness.shape == (len(ref_witness), 8)
    assert np.array_equal(witness, np.asarray(ref_witness, dtype=np.uint32).reshape(-1, 8))


def test_header_walk_above_shared_memory(host_decommit):
    """The walk over a pass whose position lists exceed shared memory (the
    card keeps them in device memory): the twin's words."""
    _, port, queries = _above_old_cap()
    plan = kernels.DecommitPass([port.desc], [queries])
    assert not plan.in_shared
    packed = np.ascontiguousarray(plan.packed)
    out = np.zeros(plan.n_words, dtype=np.int32)
    host_decommit.h_decommit(packed.ctypes.data_as(ctypes.c_void_p), 1, plan.slices, plan.cap,
                             out.ctypes.data_as(ctypes.c_void_p))
    assert np.array_equal(out, kernels.decommit_plain(plan).numpy())
