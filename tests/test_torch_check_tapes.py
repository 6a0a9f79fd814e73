"""The constraint check compiled per component (csrc/check.cuh, the
generated csrc/check_tapes.cuh): the committed header against its
generator (air/tape_cuda.py), the check built with g++ and run CTA by CTA
on a launch's table against the plain twin `tape.check_plain`, with
mutations that must fail; the wrapper's refusals; the batched carry pass's
twin against the one-block twin."""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from luminair_tpu_torch import fields as f
from luminair_tpu_torch import kernels
from luminair_tpu_torch.air import tape, tape_cuda
from luminair_tpu_torch.air.components import ALL_COMPONENTS
from luminair_tpu_torch.errors import KernelError

NAMES = [c.name for c in ALL_COMPONENTS]
CSRC = Path(kernels.__file__).resolve().parent / "csrc"


def _function(text: str, name: str) -> str:
    m = re.search(rf"^// {name}: .*?^}}$", text, re.M | re.S)
    assert m, name
    return m.group(0)


# --- the committed header ----------------------------------------------------


def test_header_equals_the_generator():
    assert (CSRC / kernels.CHECK_TAPES_HEADER).read_text() == tape_cuda.generate()


@pytest.mark.parametrize("name", NAMES)
def test_header_holds_the_component_tape(name):
    """The component's function in the header is its tape's, and the
    manifest names the tape by its digest and kind."""
    tp = tape.record(ALL_COMPONENTS[NAMES.index(name)])
    text = (CSRC / kernels.CHECK_TAPES_HEADER).read_text()
    assert _function(text, name) == "\n".join(tape_cuda.tape_function(tp))
    assert kernels.compiled_check_tapes()[name] == (NAMES.index(name), kernels.tape_digest(tp))
    assert kernels._check_kind(tp) == NAMES.index(name)


def test_a_stale_header_is_refused(tmp_path, monkeypatch):
    """A header generated before a tape changed: its digest no longer
    matches, the freshness comparison fails and the wrapper refuses the
    tape."""
    text = tape_cuda.generate()
    tp = tape.record(ALL_COMPONENTS[NAMES.index("mul")])
    older = tape.Tape(tp.name, tp.words[:-5], tp.n_regs, tp.n_constraints, tp.n_relations, tp.n_main, tp.n_pp)
    stale = text.replace(kernels.tape_digest(tp), kernels.tape_digest(older))
    assert stale != text
    path = tmp_path / kernels.CHECK_TAPES_HEADER
    path.write_text(stale)
    monkeypatch.setattr(kernels, "compiled_check_tapes", lambda header=None, read=kernels.compiled_check_tapes: read(path))
    with pytest.raises(KernelError, match="no compiled check tape"):
        kernels._check_kind(tp)
    assert kernels._check_kind(tape.record(ALL_COMPONENTS[0])) == 0


# --- the wrapper's refusals ---------------------------------------------------


def _args(comp, n, rng, device="cpu"):
    tp = tape.record(comp)

    def col():
        return torch.from_numpy(rng.integers(0, f.P, n).astype(np.int32)).to(device)

    return (tp, [col() for _ in comp.MAIN], [col() for _ in comp.PP_IDS],
            [col() for _ in range(4 * tp.n_relations)], col(), tuple(int(x) for x in rng.integers(0, f.P, 4)))


def _ew(rng):
    return [[tuple(int(x) for x in rng.integers(0, f.P, 4)) for _ in range(2)] for _ in tape.ELEM_KINDS]


def test_the_wrapper_refuses_a_tape_that_is_not_compiled():
    rng = np.random.default_rng(1)
    comp = ALL_COMPONENTS[NAMES.index("mul")]
    tp, main, pp, inter, is_first, claimed = _args(comp, 8, rng)
    other = tape.Tape(tp.name, list(tp.words[:-5]) + [tape.OP_CONSTRAINT, 0, 0, 0, 0], tp.n_regs,
                      tp.n_constraints + 1, tp.n_relations, tp.n_main, tp.n_pp)
    with pytest.raises(KernelError, match="no compiled check tape"):
        kernels.air_check(other, main, pp, inter, is_first, claimed, _ew(rng))
    renamed = tape.Tape("not_a_component", tp.words, tp.n_regs, tp.n_constraints, tp.n_relations, tp.n_main, tp.n_pp)
    with pytest.raises(KernelError, match="no compiled check tape"):
        kernels.air_check_many([(tp, main, pp, inter, is_first, claimed),
                                (renamed, main, pp, inter, is_first, claimed)], _ew(rng))
    # The same words over another column layout: the compiled code
    # hard-codes where the preprocessed columns and is_first lie.
    wider = tape.Tape(tp.name, tp.words, tp.n_regs, tp.n_constraints, tp.n_relations, tp.n_main + 1, tp.n_pp)
    with pytest.raises(KernelError, match="no compiled check tape"):
        kernels.air_check(wider, main + [main[0]], pp, inter, is_first, claimed, _ew(rng))
    more_pp = tape.Tape(tp.name, tp.words, tp.n_regs, tp.n_constraints, tp.n_relations, tp.n_main, tp.n_pp + 1)
    with pytest.raises(KernelError, match="no compiled check tape"):
        kernels.air_check(more_pp, main, pp + [main[0]], inter, is_first, claimed, _ew(rng))
    assert torch.equal(kernels.air_check(tp, main, pp, inter, is_first, claimed, _ew(np.random.default_rng(2))),
                       tape.check_plain(tp, main, pp, inter, is_first, claimed, _ew(np.random.default_rng(2))))


def test_the_wrapper_refuses_a_table_that_mixes_devices():
    rng = np.random.default_rng(2)
    a = _args(ALL_COMPONENTS[NAMES.index("add")], 8, rng)
    b = _args(ALL_COMPONENTS[NAMES.index("inputs")], 8, rng, "meta")
    with pytest.raises(KernelError, match="one device"):
        kernels.air_check_many([a, b], _ew(rng))
    tp, main, pp, inter, is_first, claimed = a
    with pytest.raises(KernelError, match="one device"):
        kernels.air_check(tp, main, pp, inter, is_first.to("meta"), claimed, _ew(rng))
    with pytest.raises(KernelError):
        kernels.air_check_many([], _ew(rng))


# --- the host build of the check ----------------------------------------------

_SHIM = r"""
#define __host__
#define __device__
#define __forceinline__ inline
#include "check.cuh"
extern "C" long long h_args_size() { return sizeof(lum::CheckArgs); }
extern "C" long long h_threads() { return lum::CHECK_THREADS; }
extern "C" long long h_kinds() { return lum::CHECK_KINDS; }
// Every CTA of the launch, in `order`, each thread of it in turn.
extern "C" void h_check(const lum::CheckArgs* a, const int* order) {
  for (int i = 0; i < a->n_ctas; i++)
    for (int t = 0; t < lum::CHECK_THREADS; t++) lum::check_cta_row(*a, order[i], t);
}
"""


def _build(d: Path, check: str, tapes: str, row: str = None):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no C++ compiler for the host build of csrc/check.cuh")
    (d / "check.cuh").write_text(check)
    (d / kernels.CHECK_TAPES_HEADER).write_text(tapes)
    (d / "tape_row.cuh").write_text(row if row is not None else (CSRC / "tape_row.cuh").read_text())
    (d / "m31.cuh").write_text((CSRC / "m31.cuh").read_text())
    (d / "shim.cpp").write_text(_SHIM)
    subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-I", str(d), "-o", str(d / "check.so"),
                    str(d / "shim.cpp")], check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(d / "check.so"))
    lib.h_args_size.restype = lib.h_threads.restype = lib.h_kinds.restype = ctypes.c_longlong
    assert lib.h_args_size() == ctypes.sizeof(kernels.CheckArgs)
    assert lib.h_threads() == kernels.CHECK_THREADS
    assert lib.h_kinds() == len(kernels.compiled_check_tapes()) == len(ALL_COMPONENTS)
    lib.h_check.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    return lib


def _host_check(lib, comps, ew, seed=0):
    """kernels.air_check_many's launch on CPU tensors, its CTAs run by the
    host build in a shuffled order."""
    kinds, ptrs, _ = kernels._check_table(comps)
    out = torch.full((sum(c[4].shape[0] for c in comps),), -1, dtype=torch.int32)
    a = kernels._check_args(comps, kinds, ptrs, ew, out)
    order = np.random.default_rng(seed).permutation(a.n_ctas).astype(np.int32)
    lib.h_check(ctypes.addressof(a), order.ctypes.data)
    return out


@pytest.fixture(scope="module")
def host_check(tmp_path_factory):
    return _build(tmp_path_factory.mktemp("check"), (CSRC / "check.cuh").read_text(),
                  (CSRC / kernels.CHECK_TAPES_HEADER).read_text())


def _honest(comp, n, rng, ew):
    """Trace words from {0, 1, 2} (each recorded constraint vanishes on some
    rows and not on others) and the interaction and claimed sum that K5's
    twin builds from them (every LogUp constraint vanishes)."""
    tp = tape.record(comp)
    main = [torch.from_numpy(rng.integers(0, 3, n).astype(np.int32)) for _ in comp.MAIN]
    pp = [torch.from_numpy(rng.integers(0, 3, n).astype(np.int32)) for _ in comp.PP_IDS]
    inter, claimed = tape.witness_plain(tape.record(comp, witness=True), main, pp, ew)
    is_first = torch.zeros(n, dtype=torch.int32)
    is_first[0] = 1
    return tp, main, pp, list(inter.unbind(0)), is_first, tuple(int(x) for x in claimed)


def _fill(args, fill):
    if fill == "random":
        return args
    tp, main, pp, inter, is_first, claimed = args
    zero = [torch.zeros_like(c) for c in main + pp + inter]
    first = torch.zeros_like(is_first)
    first[0] = 1
    return (tp, zero[: len(main)], zero[len(main) : len(main) + len(pp)], zero[len(main) + len(pp) :], first,
            claimed)


# Random words (every constraint fails nearly everywhere), zeros (every
# recorded constraint vanishes, the LogUp ones where their multiplicity is
# 0) and small words with their honest interaction (`_honest`); one row,
# and rows below and above a CTA (256).
@pytest.mark.parametrize("fill", ["random", "zeros", "honest"])
@pytest.mark.parametrize("log", [0, 6, 10])
@pytest.mark.parametrize("name", NAMES)
def test_host_build_equals_the_twin(host_check, name, log, fill):
    rng = np.random.default_rng(NAMES.index(name) + 100 * log)
    ew = _ew(rng)
    comp = ALL_COMPONENTS[NAMES.index(name)]
    args = _honest(comp, 1 << log, rng, ew) if fill == "honest" else _fill(_args(comp, 1 << log, rng), fill)
    got = _host_check(host_check, [args], ew, seed=log)
    assert torch.equal(got, tape.check_plain(*args, ew))
    assert torch.equal(got, kernels.air_check(*args, ew))


def test_host_build_of_every_component_in_one_launch(host_check):
    """All 18 components in one table, each of its own size (1 to 2^10
    rows), random and zero words mixed: one launch's words against the
    twins, component by component."""
    rng = np.random.default_rng(7)
    ew = _ew(rng)
    comps = [(_honest(c, 1 << int(rng.integers(0, 11)), rng, ew) if i % 3 == 2 else
              _fill(_args(c, 1 << int(rng.integers(0, 11)), rng), "random" if i % 3 else "zeros"))
             for i, c in enumerate(ALL_COMPONENTS)]
    got = _host_check(host_check, comps, ew, seed=3)
    assert torch.equal(got, kernels.air_check_many_plain(comps, ew))
    assert torch.equal(got, kernels.air_check_many(comps, ew))
    assert (got != 0).any() and (got == 0).any()


def test_honest_words_set_only_recorded_constraint_bits():
    """The mutation tests' data: no LogUp bit, some recorded bit of every
    component with recorded constraints, and most of those components
    with rows where every constraint vanishes."""
    rng = np.random.default_rng(5)
    ew = _ew(rng)
    clean = []
    for comp in ALL_COMPONENTS:
        tp, *rest = _honest(comp, 1 << 9, rng, ew)
        words = tape.check_plain(tp, *rest, ew).to(torch.int64) & 0xFFFFFFFF
        assert not (words >> tp.n_constraints).any(), comp.name
        assert tp.n_constraints == 0 or (words != 0).any(), comp.name
        clean.append(tp.n_constraints == 0 or bool((words == 0).any()))
    assert sum(clean) > len(clean) // 2


def test_a_launch_past_its_column_table_is_refused():
    rng = np.random.default_rng(9)
    comps = [_args(ALL_COMPONENTS[NAMES.index("less_than")], 2, rng)] * (kernels.CHECK_MAX_COLS // 51 + 1)
    with pytest.raises(KernelError, match="columns"):
        kernels.air_check_many(comps, _ew(rng))
    with pytest.raises(KernelError, match="components"):
        kernels.air_check_many([_args(ALL_COMPONENTS[0], 2, rng)] * (kernels.CHECK_MAX_COMPS + 1), _ew(rng))


# Each breaks one rule of the check in check.cuh or in the row accessor it
# shares with K5 and K6 (tape_row.cuh); the host build must then disagree
# with the twin somewhere on small words with their honest interaction.
MUTATIONS = {
    "no claimed sum": ("tape_row.cuh", "qmul_m31(qload(claimed), at(First))", "qmul_m31(qload(claimed), 0u)"),
    "previous row is this row": ("tape_row.cuh", "return quad(Col, rp);", "return quad(Col, r);"),
    "next row is this row": ("check.cuh", "(r + 1) & (c.n - 1)", "r"),
    "entries not chained": ("tape_row.cuh", "    prev = s;\n", "\n"),
    "second value dropped": ("tape_row.cuh", "if constexpr (Two) d", "if constexpr (false) d"),
    "rows of another CTA": ("check.cuh", "(long long)(cta - c.cta0) * CHECK_THREADS",
                            "(long long)(cta - c.cta0 + 1) * CHECK_THREADS"),
    "nonzero's bit misplaced": ("tape_row.cuh", "return (x | (0u - x)) >> 31;", "return (x | (0u - x)) >> 30;"),
}


@pytest.mark.parametrize("mutation", sorted(MUTATIONS))
def test_mutated_check_fails(tmp_path, mutation):
    name, old, new = MUTATIONS[mutation]
    texts = {n: (CSRC / n).read_text() for n in ("check.cuh", "tape_row.cuh")}
    assert old in texts[name]
    texts[name] = texts[name].replace(old, new)
    lib = _build(tmp_path, texts["check.cuh"], (CSRC / kernels.CHECK_TAPES_HEADER).read_text(), texts["tape_row.cuh"])
    rng = np.random.default_rng(11)
    ew = _ew(rng)
    comps = [_honest(c, 1 << 9, rng, ew) for c in ALL_COMPONENTS]
    assert not torch.equal(_host_check(lib, comps, ew), kernels.air_check_many_plain(comps, ew))


def test_mutated_generator_fails(tmp_path, monkeypatch):
    """A generator that writes a subtraction as an addition: the header it
    writes gives other words."""
    monkeypatch.setattr(tape_cuda, "_BINARY", {**tape_cuda._BINARY, tape.OP_SUB: "add"})
    lib = _build(tmp_path, (CSRC / "check.cuh").read_text(), tape_cuda.generate())
    rng = np.random.default_rng(12)
    ew = _ew(rng)
    comps = [_honest(c, 1 << 8, rng, ew) for c in ALL_COMPONENTS]
    assert not torch.equal(_host_check(lib, comps, ew), kernels.air_check_many_plain(comps, ew))


# --- the batched carry pass ---------------------------------------------------


@pytest.mark.parametrize("lengths", [(1,), (3, 8, 1 << 10), (4, 4, 2, 1 << 12, 5)])
def test_batched_carry_twin_equals_the_one_block_twin(lengths):
    rng = np.random.default_rng(len(lengths))
    blocks = [torch.from_numpy(rng.integers(0, f.P, (4, n)).astype(np.int32)) for n in lengths]
    carry = torch.from_numpy(rng.integers(0, f.P, (len(blocks), 4)).astype(np.int32))
    want = [kernels.add_carry_plain(b.clone(), c.clone()) for b, c in zip(blocks, carry)]
    got = [b.clone() for b in blocks]
    assert kernels.add_carry_plain(got, carry) is got
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    again = [b.clone() for b in blocks]
    kernels.add_carry(again, carry)
    assert all(torch.equal(g, w) for g, w in zip(again, want))


def test_batched_carry_refuses_what_it_cannot_take():
    rows = [torch.zeros((4, 8), dtype=torch.int32) for _ in range(3)]
    with pytest.raises(KernelError):
        kernels.add_carry(rows, torch.zeros((2, 4), dtype=torch.int32))
    with pytest.raises(KernelError):
        kernels.add_carry(rows, torch.zeros(4, dtype=torch.int32))
    with pytest.raises(KernelError):
        kernels.add_carry([r.to(torch.int64) for r in rows], torch.zeros((3, 4), dtype=torch.int32))
    with pytest.raises(KernelError):
        kernels.add_carry(rows * 11, torch.zeros((33, 4), dtype=torch.int32))
