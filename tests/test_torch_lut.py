"""T4, the LUT boundary of the settings pre-pass (csrc/trace.cu, body in
csrc/lut.cuh): the header built with g++ and run CTA by CTA, each CTA a
block of host threads, against the plain twin `kernels.lut_boundary_plain`
(numpy's min and max beside the gathered input, the reference's
(inp, jnp.min, jnp.max))."""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from luminair_tpu_torch import kernels
from luminair_tpu_torch.errors import KernelError

I64 = np.iinfo(np.int64)

_SHIM = r"""
#include <algorithm>
#include <numeric>
#include <random>
#include <vector>
#define __host__
#define __device__
#define __forceinline__ inline
#include "lut.cuh"
// A CTA of T threads whose phases run thread after thread.
struct HostBlock {
  int T;
  int threads() const { return T; }
  void sync() const {}
  template <class F>
  void each(F f) const { for (int t = 0; t < T; t++) f(t); }
  void minmax(long long* lo, long long* hi) const {
    for (int t = 1; t < T; t++) {
      lo[0] = std::min(lo[0], lo[t]);
      hi[0] = std::max(hi[0], hi[t]);
    }
  }
};
extern "C" long long h_words(long long n, long long gn, int T) { return lum::lut_boundary_words(n, gn, T); }
extern "C" long long h_ctas(long long n, int T) { return lum::lut_ctas(n, T); }
// One launch: its CTAs in a seeded shuffled order, as the card may run them.
extern "C" void h_boundary(const long long* src, long long n, const long long* gathered, long long gn,
                           long long* out, long long out_words, int T, unsigned seed) {
  const long long grid = lum::lut_ctas(n, T);
  std::vector<long long> order(grid), lo(T), hi(T);
  int last = 0;
  std::iota(order.begin(), order.end(), 0);
  std::mt19937 rng(seed);
  std::shuffle(order.begin(), order.end(), rng);
  const lum::LutArgs a{src, n, gathered, gn, out, out_words};
  for (long long c : order) lum::lut_boundary_cta(HostBlock{T}, a, c, grid, lo.data(), hi.data(), &last);
}
"""


def _header():
    return (Path(kernels.__file__).resolve().parent / "csrc" / "lut.cuh").read_text()


def _build(d: Path, header: str):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no C++ compiler for the host build of csrc/lut.cuh")
    (d / "lut.cuh").write_text(header)
    (d / "shim.cpp").write_text(_SHIM)
    subprocess.run([cxx, "-std=c++17", "-O1", "-Wno-unknown-pragmas", "-shared", "-fPIC", "-I", str(d), "-o",
                    str(d / "lut.so"), str(d / "shim.cpp")], check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(d / "lut.so"))
    lib.h_words.restype = lib.h_ctas.restype = ctypes.c_longlong
    lib.h_words.argtypes = [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int]
    lib.h_ctas.argtypes = [ctypes.c_longlong, ctypes.c_int]
    lib.h_boundary.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong,
                               ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_uint]
    return lib


@pytest.fixture(scope="module")
def host_lut(tmp_path_factory):
    return _build(tmp_path_factory.mktemp("lut"), _header())


def _run(lib, src, gathered, threads, seed=0):
    """The boundary through the host build into a zeroed staging region;
    returns (head, the staging region)."""
    staging = torch.zeros(lib.h_words(len(src), len(gathered), threads), dtype=torch.int64)
    lib.h_boundary(src.data_ptr(), len(src), gathered.data_ptr(), len(gathered), staging.data_ptr(),
                   len(staging), threads, seed)
    return staging[: len(gathered) + 2], staging


def _values(kind, n, rng):
    if kind == "random":
        return rng.integers(-2**40, 2**40, n)
    if kind == "equal":
        return np.full(n, -12345, dtype=np.int64)
    if kind == "extremes":  # INT64 min and max at random places among the rest
        v = rng.integers(I64.min, I64.max, n, dtype=np.int64, endpoint=True)
        v[rng.integers(0, n)] = I64.min
        v[rng.integers(0, n)] = I64.max
        return v
    return -rng.integers(1, 2**62, n)  # negative


# n = 1, 2, 3, 1023, 16,385 (2,048 values fill one CTA of the card's 256
# threads: 16,385 takes 9 CTAs and a last-CTA pass); the source at an even
# and an odd element (16-byte aligned or not); CTAs of the card's threads,
# of 32 and of 4 (a source of 1023 then takes 32 CTAs).
@pytest.mark.parametrize("n", [1, 2, 3, 1023, 16385])
@pytest.mark.parametrize("kind", ["random", "equal", "extremes", "negative"])
@pytest.mark.parametrize("offset", [0, 1])
def test_header_equals_twin(host_lut, n, kind, offset):
    rng = np.random.default_rng(n * 7 + offset)
    buf = torch.from_numpy(np.concatenate([rng.integers(-9, 9, offset), _values(kind, n, rng)]))
    src = buf[offset:]
    assert (src.data_ptr() % 16 == 0) == (offset == 0)
    gathered = torch.from_numpy(rng.integers(-2**62, 2**62, 100 + n % 7))
    want = kernels.lut_boundary_plain(src, gathered)
    for threads in (kernels.LUT_THREADS, 32, 4):
        got, staging = _run(host_lut, src, gathered, threads, seed=n + threads)
        assert torch.equal(got, want), threads
        if host_lut.h_ctas(n, threads) > 1:
            assert staging[-1] == 0  # the counter back at 0 for the next launch


def test_staging_words_match_the_header(host_lut):
    for n in (1, 2048, 2049, 16384, 16385, 10**6, 10**8):
        assert host_lut.h_ctas(n, kernels.LUT_THREADS) == min(-(-n // 2048), kernels.LUT_MAX_CTAS)
        for gn in (0, 5, 16384):
            assert host_lut.h_words(n, gn, kernels.LUT_THREADS) == kernels.lut_boundary_words(n, gn)


def test_wrapper_raises_on_a_small_staging_region():
    src = torch.arange(40000, dtype=torch.int64)
    gathered = torch.zeros(10, dtype=torch.int64)
    words = kernels.lut_boundary_words(len(src), len(gathered))
    assert words == 10 + 2 + 2 * 20 + 1  # 20 CTAs: their partials and a counter
    with pytest.raises(KernelError, match="staging"):
        kernels.lut_boundary(src, gathered, torch.zeros(words - 1, dtype=torch.int64))
    got = kernels.lut_boundary(src, gathered, torch.zeros(words, dtype=torch.int64))
    assert got.tolist() == [0, 39999] + [0] * 10


# Mutations the twin must catch: the element after the last pair dropped,
# the first partial of each thread of the last CTA left out.
@pytest.mark.parametrize("mutation", [
    ("      if (tail < a.n) lut_take(a.src[tail], mn, mx);\n", "\n"),
    ("for (long long c = t; c < grid; c += T) {", "for (long long c = t + T; c < grid; c += T) {"),
])
def test_mutated_header_fails(tmp_path, mutation):
    old, new = mutation
    header = _header()
    assert header.count(old) == 1
    lib = _build(tmp_path, header.replace(old, new))
    rng = np.random.default_rng(5)
    src = torch.from_numpy(rng.integers(-2**40, 2**40, 1023))
    src[-1] = 2**41  # the largest value after the last pair of an odd, aligned source (CTA 0's)
    gathered = torch.from_numpy(rng.integers(0, 9, 20))
    got, _ = _run(lib, src, gathered, 4, seed=1)
    assert not torch.equal(got, kernels.lut_boundary_plain(src, gathered))
