"""K1's passes (csrc/fft.cu): the pass plan, and csrc/fft.cuh built with
g++ and run on the CPU, one CTA after another, at tiny tile sizes against
the plain twins and luminair_tpu.fft."""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from luminair_tpu import fft as ref_fft
from luminair_tpu_torch import fields as f
from luminair_tpu_torch import kernels

P = (1 << 31) - 1


def _stages(passes, inverse):
    """The stage block logs of a plan, in the order its passes run them."""
    out = []
    for log_g, log_w, lo, hi in passes:
        levels = range(hi, lo - 1, -1) if inverse else range(lo, hi + 1)
        out += [log_w + l for l in levels]
    return out


def _check_plan(passes, log_n):
    for log_g, log_w, lo, hi in passes:
        assert 1 <= lo <= hi <= log_g and log_w + log_g <= log_n
        if log_w == 0:  # a tile pass: its stages' blocks fit in the tile
            assert log_g == min(kernels.FFT_TILE_LOG, log_n)
        else:  # a group pass: levels 1..r, groups of 2^r rows in shared memory
            assert (lo, hi) == (1, log_g) and log_g <= kernels.FFT_GROUP_LOG
            assert log_w >= kernels.FFT_TILE_LOG
    assert len(passes) <= 3


@pytest.mark.parametrize("log_n", range(1, 25))
def test_pass_plan_runs_every_stage_once_in_order(log_n):
    inv = kernels.fft_passes(log_n, 1, True)
    _check_plan(inv, log_n)
    assert _stages(inv, True) == list(range(log_n, 0, -1))
    assert inv[-1][1] == 0  # the inverse ends with its tile pass
    for log_lo in range(1, log_n + 2):  # forward with m_start = 2^log_lo
        fwd = kernels.fft_passes(log_n, log_lo, False)
        _check_plan(fwd, log_n)
        assert _stages(fwd, False) == list(range(log_lo, log_n + 1))
    for log_blowup in (1, 2, 3, 4):  # the LDE of 2^log_n coefficients
        log_big = log_n + log_blowup
        log_lo = 2 if log_blowup == 1 else 1
        lde = kernels.fft_passes(log_big, log_lo, False)
        assert _stages(lde, False) == list(range(log_lo, log_big + 1))
        assert lde[0][1] == 0  # the tile pass reads the coefficients
    if log_n <= kernels.FFT_TILE_LOG + kernels.FFT_GROUP_LOG:
        assert len(inv) <= 2


# ---------------------------------------------------------------------------
# csrc/fft.cuh on the CPU.

_SHIM = r"""
#define __host__
#define __device__
#define __forceinline__ inline
#include "fft.cuh"
struct HostBlock {
  int tid() const { return 0; }
  int threads() const { return 1; }
  void sync() const {}
};
extern "C" long long h_fft_pass_size() { return sizeof(lum::FftPass); }
extern "C" void h_fft_pass(lum::FftPass p, uint32_t* sm) {
  for (long long c = 0; c < lum::fft_ctas(p); c++) lum::fft_cta(HostBlock{}, p, c, sm);
}
"""


def _build(d: Path, header: str):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no C++ compiler for the host build of csrc/fft.cuh")
    csrc = Path(kernels.__file__).resolve().parent / "csrc"
    for name in ("fft.cuh", "m31.cuh"):
        (d / name).write_text(header if name == "fft.cuh" else (csrc / name).read_text())
    (d / "shim.cpp").write_text(_SHIM)
    subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-I", str(d), "-o", str(d / "fft.so"),
                    str(d / "shim.cpp")], check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(d / "fft.so"))
    lib.h_fft_pass_size.restype = ctypes.c_longlong
    assert lib.h_fft_pass_size() == ctypes.sizeof(kernels.FftPass)
    lib.h_fft_pass.argtypes = [kernels.FftPass, ctypes.c_void_p]
    return lib


def _header():
    return (Path(kernels.__file__).resolve().parent / "csrc" / "fft.cuh").read_text()


@pytest.fixture(scope="module")
def host_fft(tmp_path_factory):
    return _build(tmp_path_factory.mktemp("fft"), _header())


def _runner(lib):
    def run(p):
        sm = np.zeros(2 << (p.log_g + p.log_groups), dtype=np.uint32)  # two buffers
        lib.h_fft_pass(p, sm.ctypes.data_as(ctypes.c_void_p))

    return run


def _transforms(lib, a: torch.Tensor, tile_log: int, group_log: int):
    """ifft, fft, and the LDE at blowups 1..4 through the header's passes."""
    run = _runner(lib)
    n_cols, n = a.shape

    def go(src, shape, lo, inverse, b=0, dup=False):
        return kernels._fft_launch(src, shape, lo, inverse, b, dup, tile_log, group_log, run)

    out = {"ifft": go(a, a.shape, 1, True), "fft": go(a, a.shape, 1, False)}
    if n >= 4:
        out["fft m_start=4"] = go(a, a.shape, 2, False)
    for b in (1, 2, 3, 4):
        dup = b == 1 and n > 1
        out[f"lde {b}"] = go(a, (n_cols, n << b), 2 if dup else 1, False, b, dup)
    return out


def _cols(seed, batch, log):
    rng = np.random.default_rng(seed)
    return rng.integers(0, P, size=(batch, 1 << log), dtype=np.int64).astype(np.uint32)


# Tiles of 2^2..2^6 rows; from 2^5 a tile pass runs its levels in more
# than one register chunk of four, and so does a group pass of 5 stages.
@pytest.mark.parametrize("tile_log,group_log", [(2, 1), (2, 2), (3, 2), (4, 3), (6, 5)])
@pytest.mark.parametrize("log_n", [1, 2, 3, 5, 8, 12])
def test_header_passes_equal_twins_and_reference(host_fft, tile_log, group_log, log_n):
    a = _cols(log_n * 10 + tile_log, 3, log_n)
    t = f.u32_to_tensor(a)
    got = _transforms(host_fft, t, tile_log, group_log)
    assert torch.equal(got["ifft"], kernels.circle_ifft_plain(t))
    assert torch.equal(got["fft"], kernels.circle_fft_plain(t))
    assert np.array_equal(f.tensor_to_u32(got["ifft"]), ref_fft.ifft(a))
    assert np.array_equal(f.tensor_to_u32(got["fft"]), ref_fft.fft(a))
    if log_n >= 2:
        assert np.array_equal(f.tensor_to_u32(got["fft m_start=4"]), ref_fft.fft(a, m_start=4))
    assert np.array_equal(f.tensor_to_u32(got["lde 1"]), ref_fft.fft_dup2(a))
    for b in (1, 2, 3, 4):
        assert torch.equal(got[f"lde {b}"], kernels.circle_lde_plain(t, b))
        assert np.array_equal(f.tensor_to_u32(got[f"lde {b}"]), ref_fft.extend_coeffs_and_fft(a, b))


# Mutations that keep every row in range (the host build has no bounds
# checks): the mirrored row read as the plain one; a group's rows swapped
# in pairs when loaded; a mini-group's twiddle taken at its plain row.
@pytest.mark.parametrize("mutation", [
    ("((reflected && (q & 1)) ? w - 1 - j : j)", "((reflected && (q & 1)) ? j : j)"),
    ("long long x = row0 + fft_row(w, q, j0 + gi", "long long x = row0 + fft_row(w, q ^ 1, j0 + gi"),
    ("fft_local(w_log, fft_local(log_wm, qm, jm, true), jp, true)",
     "fft_local(w_log, fft_local(log_wm, qm, jm, false), jp, true)"),
])
def test_mutated_group_index_fails(tmp_path, mutation):
    old, new = mutation
    header = _header()
    assert header.count(old) == 1
    lib = _build(tmp_path, header.replace(old, new))
    a = _cols(1, 2, 9)
    t = f.u32_to_tensor(a)
    got = _transforms(lib, t, 6, 5)
    assert not torch.equal(got["ifft"], kernels.circle_ifft_plain(t)) or not torch.equal(
        got["fft"], kernels.circle_fft_plain(t))


def test_header_constants_match_source():
    src = (Path(kernels.__file__).resolve().parent / "csrc" / "fft.cu").read_text()
    for name, value in (("TILE_LOG", kernels.FFT_TILE_LOG), ("GROUP_LOG", kernels.FFT_GROUP_LOG),
                        ("GROUPS_LOG", kernels.FFT_GROUPS_LOG)):
        assert re.search(rf"constexpr int {name} = {value};", src)
