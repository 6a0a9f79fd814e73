"""K7, the OODS values of many groups in one call (csrc/oods.cu): the
many-group twin against luminair_tpu.fft.eval_at_point per group, and
csrc/oods.cuh built with g++ and run on the CPU, one CTA after another,
at several chunk sizes against the twin."""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from luminair_tpu import circle as ref_circle
from luminair_tpu import fft as ref_fft
from luminair_tpu_torch import circle, fft
from luminair_tpu_torch import fields as f
from luminair_tpu_torch import kernels

P = (1 << 31) - 1

# (log, columns) per group of one call: logs below, at and above a chunk,
# the same log at two points, a group of more than 256 columns, one row.
CALLS = {
    "a prove's mix": [(6, 5), (6, 40), (4, 3), (7, 2), (4, 3)],
    "tiny logs": [(0, 3), (1, 2), (2, 1), (3, 4)],
    "many columns": [(2, 300), (5, 17)],
    "one large group": [(12, 4)],
}


def _groups(name):
    rng = np.random.default_rng(sorted(CALLS).index(name))
    out = []
    for log, n_cols in CALLS[name]:
        cols = rng.integers(0, P, size=(n_cols, 1 << log), dtype=np.int64).astype(np.uint32)
        t = rng.integers(0, P, size=4, dtype=np.int64).astype(np.uint32)
        out.append((cols, t))
    return out


def _port(groups):
    return [(f.u32_to_tensor(cols), fft.twiddle_chain(cols.shape[1].bit_length() - 1,
                                                      circle.point_from_t_qm31(f.u32_to_tensor(t, dtype=f.I64))))
            for cols, t in groups]


@pytest.mark.parametrize("name", sorted(CALLS))
def test_many_group_twin_equals_reference(name):
    groups = _groups(name)
    got = f.tensor_to_u32(kernels.oods_eval_many(_port(groups)))
    want = np.concatenate([np.stack([ref_fft.eval_at_point(c[None], ref_circle.point_from_t_qm31(t))[0]
                                     for c in cols]) for cols, t in groups])
    assert np.array_equal(got, want)


def test_eval_at_point_many_keeps_group_order():
    groups = _groups("a prove's mix")
    pts = [circle.point_from_t_qm31(f.u32_to_tensor(t, dtype=f.I64)) for _, t in groups]
    got = fft.eval_at_point_many([(f.u32_to_tensor(cols), pt) for (cols, _), pt in zip(groups, pts)])
    rows = np.cumsum([0] + [len(cols) for cols, _ in groups])
    for (cols, t), r0, r1 in zip(groups, rows[:-1], rows[1:]):
        assert np.array_equal(f.tensor_to_u32(got[r0:r1]),
                              ref_fft.eval_at_point_many(cols, ref_circle.point_from_t_qm31(t)))


def test_plan_counts_units_and_rows():
    groups = _port(_groups("a prove's mix"))
    plan = kernels._oods_plan(groups, chunk_log=4)
    # (6, 5): 5 columns x 4 chunks; (6, 40): 40 x 4; (4, 3): 3 x 1; (7, 2): 2 x 8; (4, 3): 3 x 1.
    assert (plan.n_units, plan.n_rows) == (5 * 4 + 40 * 4 + 3 + 2 * 8 + 3, 53)
    assert len(plan.desc) == kernels.OODS_HEAD + 5 * kernels.OODS_GROUP_WORDS + 53


# ---------------------------------------------------------------------------
# csrc/oods.cuh on the CPU.

_SHIM = r"""
#include <vector>
#define __host__
#define __device__
#define __forceinline__ inline
#include "oods.cuh"
struct HostBlock {
  int tid() const { return 0; }
  int threads() const { return 1; }
  int group() const { return 1; }
  void sync() const {}
  void group_sum4(unsigned long long*) const {}
  void sum4(unsigned long long*) const {}
};
extern "C" long long h_group_words() { return lum::OODS_GROUP_WORDS; }
extern "C" void h_oods(const long long* desc, int n_ctas, long long smem_words, uint32_t* partial, uint32_t* out) {
  std::vector<lum::u32x4> sm(smem_words / 4 + 1);
  for (int c = 0; c < n_ctas; c++) lum::oods_cta(HostBlock{}, desc, c, n_ctas, partial, &sm[0].v[0]);
  for (long long r = 0; r < desc[2]; r++) lum::oods_combine_row(HostBlock{}, desc, r, partial, out);
}
"""


def _header():
    return (Path(kernels.__file__).resolve().parent / "csrc" / "oods.cuh").read_text()


def _m31():
    return (Path(kernels.__file__).resolve().parent / "csrc" / "m31.cuh").read_text()


def _build(d: Path, header: str, m31: str = None):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no C++ compiler for the host build of csrc/oods.cuh")
    (d / "oods.cuh").write_text(header)
    (d / "m31.cuh").write_text(m31 if m31 is not None else _m31())
    (d / "shim.cpp").write_text(_SHIM)
    subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-I", str(d), "-o", str(d / "oods.so"),
                    str(d / "shim.cpp")], check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(d / "oods.so"))
    lib.h_group_words.restype = ctypes.c_longlong
    assert lib.h_group_words() == kernels.OODS_GROUP_WORDS
    lib.h_oods.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p]
    return lib


@pytest.fixture(scope="module")
def host_oods(tmp_path_factory):
    return _build(tmp_path_factory.mktemp("oods"), _header())


def _host_eval(lib, groups, chunk_log, n_ctas):
    plan = kernels._oods_plan(groups, chunk_log)
    desc = np.ascontiguousarray(plan.desc)
    partial = np.full(4 * plan.n_units, 0xFFFFFFFF, dtype=np.uint32)
    out = np.full((plan.n_rows, 4), 0xFFFFFFFF, dtype=np.uint32)
    lib.h_oods(desc.ctypes.data_as(ctypes.c_void_p), min(n_ctas, plan.n_units), plan.smem_words,
               partial.ctypes.data_as(ctypes.c_void_p), out.ctypes.data_as(ctypes.c_void_p))
    return out


@pytest.mark.parametrize("chunk_log,n_ctas", [(0, 5), (2, 3), (3, 7), (11, 2)])
@pytest.mark.parametrize("name", sorted(CALLS))
def test_header_equals_twin(host_oods, name, chunk_log, n_ctas):
    groups = _port(_groups(name))
    want = f.tensor_to_u32(kernels.oods_eval_many_plain(groups))
    assert np.array_equal(_host_eval(host_oods, groups, chunk_log, n_ctas), want)


def test_header_folds_the_largest_products(host_oods):
    """Every coefficient and basis word at P - 1: the folded products are
    at their largest, and 2^11 of them are summed in one chunk."""
    cols = torch.full((3, 1 << 12), P - 1, dtype=torch.int32)
    chain = [(P - 1, P - 1, P - 1, P - 1)] * 12
    want = f.tensor_to_u32(kernels.oods_eval_plain(list(cols), chain))
    assert np.array_equal(_host_eval(host_oods, [(list(cols), chain)], 11, 3), want)


# Mutations the twin must catch: a chunk's B_hi factor from the wrong
# table entry, the folded product's high part dropped and a reduction's
# fold (both in m31.cuh, shared with K4), a table built from its factors
# in the wrong order.
@pytest.mark.parametrize("mutation", [
    ("qload(t2 + 4 * (chunk >> g.a))", "qload(t2 + 4 * (chunk >> g.a >> 1))"),
    ("s += (uint32_t)(p & P) + (uint32_t)(p >> 31);", "s += (uint32_t)(p & P);"),
    ("x = (x & P) + (x >> 31);  // < 2^34", "x = (x & P);  // < 2^34"),
    ("const qm31 f = oods_factor(g, first + i);", "const qm31 f = oods_factor(g, first + n - 1 - i);"),
])
def test_mutated_header_fails(tmp_path, mutation):
    old, new = mutation
    header, m31 = _header(), _m31()
    assert header.count(old) + m31.count(old) == 1
    lib = _build(tmp_path, header.replace(old, new), m31.replace(old, new))
    groups = _port(_groups("a prove's mix"))
    want = f.tensor_to_u32(kernels.oods_eval_many_plain(groups))
    assert not np.array_equal(_host_eval(lib, groups, 2, 3), want)
