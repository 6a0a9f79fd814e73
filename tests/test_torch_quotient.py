"""K4, the DEEP quotients of every (log, point) group of a prove in one call
(csrc/quotient.cu): the many-group twin against the reference's
accel.quotient_group, the line's u * CM31 form, and csrc/quotient.cuh built
with g++ and run on the CPU, one CTA after another, against the twin."""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from luminair_tpu.fields import qm31 as ref_qm31
from luminair_tpu.parallel import accel
from luminair_tpu_torch import circle, kernels
from luminair_tpu_torch import fields as f
from luminair_tpu_torch.pcs import quotients as q

P = (1 << 31) - 1
ZERO_ROW = 5  # the row of log 4 on which the "zero denominator" call's first point lies

# (log, columns, point) per group of one call, in the order a prove makes
# them: S of 1, 7, 56 and 300 at several logs; two and three points at one
# log; logs below a thread's rows; a point whose line meets a domain row.
CALLS = {
    "several logs": [(3, 1, 0), (5, 7, 0), (4, 56, 0), (5, 3, 1), (6, 300, 0), (4, 2, 1)],
    "three points at a log": [(4, 5, 0), (4, 2, 1), (4, 3, 2), (2, 4, 0)],
    "tiny logs": [(0, 3, 0), (1, 2, 1), (1, 2, 0), (2, 1, 2)],
    "zero denominator": [(4, 6, "zero"), (4, 3, 0), (3, 2, "zero")],
}


def _point(rng, kind):
    if kind == "zero":  # the CM31 parts of zx, zy at a domain point of log 4, the u parts not 0
        x, y = (t.to(torch.int64)[ZERO_ROW].item() for t in circle.domain_table(4, torch.device("cpu")))
        return tuple(torch.tensor([c, 0] + list(rng.integers(1, P, 2)), dtype=torch.int64) for c in (x, y))
    return circle.point_from_t_qm31(torch.from_numpy(rng.integers(0, P, 4)))


def _groups(name):
    """quotient_groups of the call: random columns and sample values at
    sample points from the circle (and the crafted one), the constants
    derived as a prove derives them."""
    rng = np.random.default_rng(sorted(CALLS).index(name))
    points = {kind: _point(rng, kind) for kind in {p for _, _, p in CALLS[name]}}
    samples, evals = [], {}
    for log, n_cols, kind in CALLS[name]:
        for _ in range(n_cols):
            key = (0, len(evals))
            evals[key] = torch.from_numpy(rng.integers(0, P, 1 << log).astype(np.int32))
            samples.append(q.ColumnSample(log, *key, points[kind], rng.integers(0, P, 4).astype(np.uint32)))
    gamma = torch.from_numpy(rng.integers(0, P, 4))
    return q.quotient_groups(samples, evals, gamma)


def test_groups_keep_first_appearance_order():
    groups = _groups("several logs")
    assert [(log, len(cols)) for log, cols, _, _ in groups] == [(3, 1), (5, 7), (4, 56), (5, 3), (6, 300), (4, 2)]
    plan = kernels.QuotientPlan(groups)
    assert list(plan.rows) == [3, 5, 4, 6]
    assert list(kernels.deep_quotient_many(plan)) == [3, 5, 4, 6]


@pytest.mark.parametrize("name", ["several logs", "zero denominator"])
def test_many_group_twin_equals_reference(name):
    """deep_quotient_many_plain against the reference's jitted group
    program on JAX-CPU, the groups of a log added as the reference adds
    them."""
    groups = _groups(name)
    want = {}
    for log, cols, gs, consts in groups:
        got = np.asarray(accel.quotient_group(log, [f.tensor_to_u32(c) for c in cols], list(gs.astype(np.uint32)),
                                              *consts.astype(np.uint32)))
        want[log] = ref_qm31.add(want[log], got) if log in want else got
    out = kernels.deep_quotient_many_plain(kernels.QuotientPlan(groups))
    assert list(out) == list(want)
    for log, v in want.items():
        assert np.array_equal(f.tensor_to_u32(out[log]), v), log


def test_zero_denominator_row_adds_nothing():
    """On the row where the crafted point's line meets the domain, only the
    other group adds to the quotient."""
    groups = _groups("zero denominator")
    out = kernels.deep_quotient_many_plain(kernels.QuotientPlan(groups))
    rest = kernels.deep_quotient_many_plain(kernels.QuotientPlan([groups[1]]))
    assert torch.equal(out[4][ZERO_ROW], rest[4][ZERO_ROW])
    assert not torch.equal(out[4], rest[4])


@pytest.mark.parametrize("seed", range(4))
def test_line_lies_in_u_cm31(seed):
    """For any sample point off the base field (Im zx != 0), A, B and C have
    no CM31 part: the line is u times a CM31 value.  64 points a seed, each
    its own group, their words drawn from the whole field and from its
    edges (0, 1, P - 1)."""
    rng = np.random.default_rng(seed)
    words = np.where(rng.random((64, 8)) < 0.25, rng.choice([0, 1, P - 1], (64, 8)), rng.integers(0, P, (64, 8)))
    words[:, 2] = np.where(rng.random(64) < 0.25, rng.choice([1, P - 1], 64), rng.integers(1, P, 64))
    samples = [q.ColumnSample(1, 0, 0, (torch.from_numpy(w[:4]), torch.from_numpy(w[4:])), np.zeros(4, np.uint32))
               for w in words]
    groups = q.quotient_groups(samples, {(0, 0): torch.zeros(2, dtype=torch.int32)}, torch.tensor([1, 2, 3, 4]))
    consts = np.stack([c for _, _, _, c in groups])
    assert consts.shape == (64, 5, 4)
    assert not consts[:, :3, :2].any()
    assert consts[:, 1, 2:].any(axis=-1).all()


def test_plan_refuses_a_line_off_u_cm31():
    (log, cols, gs, consts), = _groups("tiny logs")[:1]
    consts = consts.copy()
    consts[2, 0] = 1
    with pytest.raises(kernels.KernelError, match="u \\* CM31"):
        kernels.QuotientPlan([(log, cols, gs, consts)])


def test_plan_counts_ctas_and_rows():
    plan = kernels.QuotientPlan(_groups("several logs"), cta_rows=3)
    sizes = [1 << log for log in (3, 5, 4, 6)]
    assert plan.n_rows == sum(sizes)
    assert plan.n_ctas == sum(-(-n // 3) for n in sizes)
    n_cols = 1 + 7 + 56 + 3 + 300 + 2
    assert len(plan.desc) == kernels.DQ_HEAD + 4 * kernels.DQ_LOG_WORDS + 6 * kernels.DQ_GROUP_WORDS + 3 * n_cols


# ---------------------------------------------------------------------------
# csrc/quotient.cuh on the CPU.

_SHIM = r"""
#include <vector>
#define __host__
#define __device__
#define __forceinline__ inline
#include "quotient.cuh"
struct HostBlock {
  int tid() const { return 0; }
  int threads() const { return 1; }
  void sync() const {}
};
extern "C" long long h_log_words() { return lum::DQ_LOG_WORDS; }
extern "C" long long h_group_words() { return lum::DQ_GROUP_WORDS; }
template <int R>
static void run(const long long* desc, long long n_ctas, int chunk, uint32_t* out) {
  std::vector<unsigned long long> sp(chunk);
  std::vector<lum::u32x4> sg(chunk);
  for (long long c = 0; c < n_ctas; c++) lum::dq_cta<R>(HostBlock{}, desc, c, out, sp.data(), sg.data(), chunk);
}
extern "C" int h_dq(const long long* desc, long long n_ctas, int rows, int chunk, uint32_t* out) {
  switch (rows) {
    case 1: run<1>(desc, n_ctas, chunk, out); return 0;
    case 3: run<3>(desc, n_ctas, chunk, out); return 0;
    case 4: run<4>(desc, n_ctas, chunk, out); return 0;
    case 8: run<8>(desc, n_ctas, chunk, out); return 0;
  }
  return 1;
}
"""


def _header():
    return (Path(kernels.__file__).resolve().parent / "csrc" / "quotient.cuh").read_text()


def _build(d: Path, header: str):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no C++ compiler for the host build of csrc/quotient.cuh")
    csrc = Path(kernels.__file__).resolve().parent / "csrc"
    (d / "quotient.cuh").write_text(header)
    (d / "m31.cuh").write_text((csrc / "m31.cuh").read_text())
    (d / "shim.cpp").write_text(_SHIM)
    subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-I", str(d), "-o", str(d / "quotient.so"),
                    str(d / "shim.cpp")], check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(d / "quotient.so"))
    for fn, want in ((lib.h_log_words, kernels.DQ_LOG_WORDS), (lib.h_group_words, kernels.DQ_GROUP_WORDS)):
        fn.restype = ctypes.c_longlong
        assert fn() == want
    lib.h_dq.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    return lib


@pytest.fixture(scope="module")
def host_quotient(tmp_path_factory):
    return _build(tmp_path_factory.mktemp("quotient"), _header())


def _host_many(lib, groups, rows, chunk):
    """The call through the host build: CTAs of one thread and `rows` rows,
    `chunk` columns staged at a time; {log: (2^log, 4) int32}."""
    plan = kernels.QuotientPlan(groups, cta_rows=rows)
    out = torch.full((plan.n_rows, 4), -1, dtype=torch.int32)
    desc = np.ascontiguousarray(plan.desc)
    assert lib.h_dq(desc.ctypes.data_as(ctypes.c_void_p), plan.n_ctas, rows, chunk, out.data_ptr()) == 0
    return {log: out[r0 : r0 + (1 << log)] for log, r0 in plan.rows.items()}


def _same(got, want):
    return list(got) == list(want) and all(torch.equal(got[log], want[log]) for log in want)


# Rows per thread dividing a CTA's rows and not (3), chunks of columns below
# and above a group's width.
@pytest.mark.parametrize("rows,chunk", [(1, 256), (3, 5), (4, 2), (8, 256)])
@pytest.mark.parametrize("name", sorted(CALLS))
def test_header_equals_twin(host_quotient, name, rows, chunk):
    groups = _groups(name)
    want = kernels.deep_quotient_many_plain(kernels.QuotientPlan(groups))
    assert _same(_host_many(host_quotient, groups, rows, chunk), want)


def test_header_folds_the_largest_products(host_quotient):
    """Every column word and gamma at P - 1: the folded products are at
    their largest, 300 of them in one sum."""
    groups = [(log, [torch.full_like(c, P - 1) for c in cols], np.full_like(gs, P - 1), consts)
              for log, cols, gs, consts in _groups("several logs")]
    want = kernels.deep_quotient_many_plain(kernels.QuotientPlan(groups))
    assert _same(_host_many(host_quotient, groups, 4, 256), want)


# Mutations the twin must catch: a zero denominator's numerator kept, the
# second fraction's denominator cut to its real part, the batch inverse
# taken from the wrong prefix, a conjugate sign lost, every chunk staged
# from a group's first column.
@pytest.mark.parametrize("mutation,name", [
    (("        num = {0, 0, 0, 0};\n", ""), "zero denominator"),
    (("dq_mac_cm(acc, num, Dr[r], Di[r]);", "dq_mac_cm(acc, num, Dr[r], 0);"), "three points at a log"),
    (("ninv = mul(inv_all, pre[r - 1]);", "ninv = mul(inv_all, pre[r]);"), "several logs"),
    (("fold_mac(acc[0], P - q.b, f);", "fold_mac(acc[0], q.b, f);"), "several logs"),
    (("sptr[k] = (unsigned long long)ptrs[first + c0 + k];", "sptr[k] = (unsigned long long)ptrs[first + k];"),
     "several logs"),
])
def test_mutated_header_fails(tmp_path, mutation, name):
    old, new = mutation
    header = _header()
    assert header.count(old) == 1
    lib = _build(tmp_path, header.replace(old, new))
    groups = _groups(name)
    want = kernels.deep_quotient_many_plain(kernels.QuotientPlan(groups))
    assert not _same(_host_many(lib, groups, 3, 5), want)
