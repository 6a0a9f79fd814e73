"""K3, the folds of one committed FRI layer in one launch (csrc/fri.cu):
csrc/fri.cuh built with g++ and run row by row against the plain twin
`kernels.fri_layer_plain`, and `pcs/fri.commit_chain` with its layers
through that host build against the reference's device chain
(luminair_tpu.parallel.accel.fri_commit_chain on JAX's CPU)."""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from luminair_tpu.parallel import accel
from luminair_tpu_torch import circle
from luminair_tpu_torch import fields as f
from luminair_tpu_torch import kernels
from luminair_tpu_torch.errors import KernelError
from luminair_tpu_torch.pcs import fri

P = (1 << 31) - 1

_SHIM = r"""
#define __host__
#define __device__
#define __forceinline__ inline
#include "fri.cuh"
extern "C" long long h_layer_size() { return sizeof(lum::FriLayer); }
extern "C" long long h_max_folds() { return lum::FRI_MAX_FOLDS; }
extern "C" void h_layer(const lum::FriLayer* a) {
  for (long long i = 0; i < a->n; i++) {
    switch (a->folds) {
      case 1: lum::fri_layer_row<1>(*a, i); break;
      case 2: lum::fri_layer_row<2>(*a, i); break;
      case 3: lum::fri_layer_row<3>(*a, i); break;
      case 4: lum::fri_layer_row<4>(*a, i); break;
    }
  }
}
"""


def _header():
    return (Path(kernels.__file__).resolve().parent / "csrc" / "fri.cuh").read_text()


def _build(d: Path, header: str):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no C++ compiler for the host build of csrc/fri.cuh")
    csrc = Path(kernels.__file__).resolve().parent / "csrc"
    (d / "fri.cuh").write_text(header)
    (d / "m31.cuh").write_text((csrc / "m31.cuh").read_text())
    (d / "shim.cpp").write_text(_SHIM)
    subprocess.run([cxx, "-std=c++17", "-O1", "-Wno-unknown-pragmas", "-shared", "-fPIC", "-I", str(d), "-o",
                    str(d / "fri.so"), str(d / "shim.cpp")], check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(d / "fri.so"))
    lib.h_layer_size.restype = lib.h_max_folds.restype = ctypes.c_longlong
    assert lib.h_layer_size() == ctypes.sizeof(kernels.FriLayer)
    assert lib.h_max_folds() == kernels.FRI_MAX_FOLDS
    lib.h_layer.argtypes = [ctypes.c_void_p]
    return lib


def _host_layer(lib):
    """kernels.fri_layer with the wrapper's checks, its rows written by the
    host build."""
    checked = kernels.fri_layer

    def layer(values, twiddles, alpha, t0=0, mixes=None, alpha0=None):
        checked(values, twiddles, alpha, t0, mixes, alpha0)  # the checks (the twin's result unused)
        mixes = list(mixes) if mixes is not None else [None] * len(twiddles)
        return kernels._fri_layer_launch(values, twiddles, alpha, t0, mixes, alpha0,
                                         lambda a: lib.h_layer(ctypes.addressof(a)))
    return layer


@pytest.fixture(scope="module")
def host_fri(tmp_path_factory):
    return _build(tmp_path_factory.mktemp("fri"), _header())


def _qm31(rng, rows):
    return f.u32_to_tensor(rng.integers(0, P, size=(rows, 4), dtype=np.int64).astype(np.uint32))


def _layer_args(kmax, folds, joins, seed, t0=0):
    """A layer at line log kmax - 1 with `folds` folds, an input of circle
    log L - t joining at each fold t in `joins`; random values."""
    rng = np.random.default_rng(seed)
    L = kmax - 1
    values = _qm31(rng, 1 << L)
    twiddles = [circle.twiddle_stage(kmax, kmax - (L - t), True, values.device) for t in range(folds)]
    mixes = [(_qm31(rng, 1 << (L - t)), circle.twiddle_stage(L - t, 0, True, values.device)) if t in joins else None
             for t in range(folds)]
    return values, twiddles, _qm31(rng, 1)[0], t0, mixes, _qm31(rng, 1)[0]


# kmax 8-10, one to three folds a launch, inputs joining at every fold
# position (t = 0, 1, 2), with gaps, consecutive, or none.
@pytest.mark.parametrize("kmax", [8, 9, 10])
@pytest.mark.parametrize("folds,joins", [
    (1, ()), (1, (0,)), (2, (0, 1)), (2, (1,)), (3, (0, 1, 2)), (3, (0, 2)), (3, (2,)), (3, ()),
])
def test_header_layer_equals_twin(host_fri, kmax, folds, joins):
    args = _layer_args(kmax, folds, joins, kmax * 10 + folds + 7 * len(joins))
    got = _host_layer(host_fri)(*args)
    assert got.shape == (1 << (kmax - 1 - folds), 4)
    assert torch.equal(got, kernels.fri_layer_plain(*args))


@pytest.mark.parametrize("t0", [1, 3])
def test_header_layer_starts_at_a_later_fold(host_fri, t0):
    """beta_0 = alpha^(2^t0): a layer taken up at fold t0 of its challenge."""
    args = _layer_args(9, 2, (1,), 40 + t0, t0)
    assert torch.equal(_host_layer(host_fri)(*args), kernels.fri_layer_plain(*args))


def test_header_circle_fold_equals_twin(host_fri):
    """The largest input's circle fold: a layer of one fold with the circle
    domain's twiddles and alpha0."""
    rng = np.random.default_rng(3)
    v, alpha0 = _qm31(rng, 1 << 10), _qm31(rng, 1)[0]
    tw = [circle.twiddle_stage(10, 0, True, v.device)]
    assert torch.equal(_host_layer(host_fri)(v, tw, alpha0), kernels.fri_layer_plain(v, tw, alpha0))


def test_layer_twin_composes_one_fold_layers():
    """Two folds in one layer are the two one-fold layers in turn, the
    second at fold index 1 (beta squared), each input joining where its
    line size is reached."""
    values, twiddles, alpha, _, mixes, alpha0 = _layer_args(9, 2, (0, 1), 11)
    once = kernels.fri_layer_plain(values, twiddles[:1], alpha, 0, mixes[:1], alpha0)
    twice = kernels.fri_layer_plain(once, twiddles[1:], alpha, 1, mixes[1:], alpha0)
    assert torch.equal(kernels.fri_layer_plain(values, twiddles, alpha, 0, mixes, alpha0), twice)


def test_fold_cap_raises():
    """More than FRI_MAX_FOLDS folds a launch, no fold, or a layer that
    cannot fold that often raise."""
    rng = np.random.default_rng(1)
    alpha = _qm31(rng, 1)[0]
    v = _qm31(rng, 1 << 8)
    tws = [circle.twiddle_stage(9, 1 + t, True, v.device) for t in range(kernels.FRI_MAX_FOLDS + 1)]
    with pytest.raises(KernelError, match="folds a launch"):
        kernels.fri_layer(v, tws, alpha)
    with pytest.raises(KernelError, match="folds a launch"):
        kernels.fri_layer(v, [], alpha)
    with pytest.raises(KernelError, match="do not fold"):
        kernels.fri_layer(_qm31(rng, 4), tws[:3], alpha)
    with pytest.raises(KernelError, match="alpha0"):
        kernels.fri_layer(v, tws[:1], alpha, 0, [(_qm31(rng, 1 << 8), circle.twiddle_stage(8, 0, True, v.device))])


# pcs/fri.commit_chain with every K3 launch through the host build, against
# the reference's chain: kmax 8-10, one to three folds a layer, a one-fold
# tail layer, inputs consecutive and with gaps.
CHAINS = [
    ((8, 7, 6, 5), 3, 2),   # 7 -> 4 -> 3 (tail of one); joins at t = 0, 1, 2
    ((9, 8, 6, 4), 2, 2),   # 8 -> 6 -> 4 -> 3 (tail of one); joins at t = 0 and gaps
    ((10, 9, 7, 5), 3, 2),  # 9 -> 6 -> 3
    ((10, 6), 1, 2),        # one fold a layer, one input far below
    ((10, 9, 7, 5), 5, 2),  # 9 -> 4 -> 3: a layer of five folds, two launches (4 + 1)
]


@pytest.mark.parametrize("logs,folds,bound", CHAINS)
def test_commit_chain_through_header_matches_reference(host_fri, monkeypatch, logs, folds, bound):
    rng = np.random.default_rng(sum(logs) + folds)
    inputs = {k: rng.integers(0, P, size=(1 << k, 4), dtype=np.int64).astype(np.uint32) for k in logs}
    B = 1
    digest = rng.integers(0, 1 << 32, 8, dtype=np.uint64).astype("<u4").tobytes()
    ref = accel.fri_commit_chain(inputs, B, bound, folds, B + bound, digest, 5)
    launches = []
    layer = _host_layer(host_fri)

    def counted(*args, **kw):
        launches.append(len(args[1]))
        return layer(*args, **kw)

    monkeypatch.setattr(kernels, "fri_layer", counted)
    got = fri.commit_chain({k: f.u32_to_tensor(v) for k, v in inputs.items()}, B + bound, folds, digest, 5)
    schedule = fri.layer_schedule(max(logs), B + bound, folds)
    # The circle fold, then a launch a layer (or per FRI_MAX_FOLDS folds of it).
    cap = kernels.FRI_MAX_FOLDS
    assert launches == [1] + [min(cap, fl - t) for _, fl in schedule for t in range(0, fl, cap)]
    assert got[0] == ref[0] and got[1] == ref[1]
    for a, b in zip(got[2] + got[3], ref[2] + ref[3]):
        assert np.array_equal(a, np.asarray(b, dtype=np.uint32))
    assert len(got[2]) == len(ref[2]) == len(schedule)
    assert np.array_equal(got[4], ref[4])
    assert np.array_equal(f.tensor_to_u32(got[5]), ref[5])
    assert not ref[6]


# Mutations the twin must catch: the descending row of a pair off by one,
# beta not squared between folds, a joining input scaled by beta, not beta^2.
@pytest.mark.parametrize("mutation", [
    ("p[(2 * k + 1) << t] = N - 1 - p[(2 * k) << t];", "p[(2 * k + 1) << t] = N - 2 - p[(2 * k) << t];"),
    ("    beta = beta2;\n", "\n"),
    ("r = qadd(r, qmul(beta2, m));", "r = qadd(r, qmul(beta, m));"),
])
def test_mutated_header_fails(tmp_path, mutation):
    old, new = mutation
    header = _header()
    assert header.count(old) == 1
    lib = _build(tmp_path, header.replace(old, new))
    args = _layer_args(9, 3, (0, 1, 2), 77)
    assert not torch.equal(_host_layer(lib)(*args), kernels.fri_layer_plain(*args))
