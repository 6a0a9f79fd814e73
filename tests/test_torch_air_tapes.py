"""K5 (the LogUp witness) and K6 (the constraint quotients) compiled per
component (csrc/air.cuh, the generated csrc/air_tapes.cuh): the committed
header against its generator (air/tape_cuda.py), the wrappers' refusals,
and a g++ build of the kernels run on a launch's table on the CPU against
the plain twins `tape.witness_plain` / `tape.domain_plain` -- K5's tiles
begun in the order drawn and ended in a seeded interleaving (the
look-back meets tiles that have published their aggregate, their prefix,
or, from an earlier launch, neither), K6's CTAs in a shuffled order, whole
domains and row blocks with halos --, with mutations of the kernels and of
the generator that must fail."""

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
HEADERS = ("m31.cuh", "tape_row.cuh", "air.cuh", kernels.AIR_TAPES_HEADER)


def _function(text: str, prefix: str, name: str) -> str:
    m = re.search(rf"^// {name}: [^\n]*\n__host__ __device__ __forceinline__ qm31 {prefix}_{name}\(.*?^}}$", text,
                  re.M | re.S)
    assert m, name
    return m.group(0)


# --- the committed header ----------------------------------------------------


def test_header_equals_the_generator():
    assert (CSRC / kernels.AIR_TAPES_HEADER).read_text() == tape_cuda.generate_air()


@pytest.mark.parametrize("name", NAMES)
def test_header_holds_the_component_tapes(name):
    """The component's witness and domain functions in the header are its
    tapes', and the manifest names each tape by its digest and kind."""
    comp = ALL_COMPONENTS[NAMES.index(name)]
    text = (CSRC / kernels.AIR_TAPES_HEADER).read_text()
    for family, tp, gen in (("witness", tape.record(comp, witness=True), tape_cuda.witness_function),
                            ("domain", tape.record(comp), tape_cuda.domain_function)):
        assert _function(text, f"{family}_tape", name) == "\n".join(gen(tp))
        assert kernels.compiled_air_tapes()[(family, name)] == (NAMES.index(name), kernels.tape_digest(tp))
        assert kernels._air_kind(tp, family) == NAMES.index(name)


@pytest.mark.parametrize("family", ["witness", "domain"])
def test_a_stale_header_is_refused(tmp_path, monkeypatch, family):
    """A header generated before a tape changed: its digest no longer
    matches and the wrapper refuses the tape."""
    text = tape_cuda.generate_air()
    comp = ALL_COMPONENTS[NAMES.index("mul")]
    tp = tape.record(comp, witness=family == "witness")
    older = tape.Tape(tp.name, tp.words[:-5], tp.n_regs, tp.n_constraints, tp.n_relations, tp.n_main, tp.n_pp)
    stale = text.replace(f"{family} 1 mul {kernels.tape_digest(tp)}", f"{family} 1 mul {kernels.tape_digest(older)}")
    assert stale != text
    path = tmp_path / kernels.AIR_TAPES_HEADER
    path.write_text(stale)
    monkeypatch.setattr(kernels, "compiled_air_tapes", lambda header=None, read=kernels.compiled_air_tapes: read(path))
    with pytest.raises(KernelError, match=f"no compiled {family} tape"):
        kernels._air_kind(tp, family)
    other = "domain" if family == "witness" else "witness"
    assert kernels._air_kind(tape.record(comp, witness=other == "witness"), other) == 1


# --- test data ----------------------------------------------------------------


def _col(rng, n, fill):
    if fill == "zeros":
        return torch.zeros(n, dtype=torch.int32)
    return torch.from_numpy(rng.integers(0, 3 if fill == "honest" else f.P, n).astype(np.int32))


def _ew(rng, undrawn=()):
    """Lookup elements' words; the kinds in `undrawn` all zero, as
    `tape.element_words` gives them for kinds a claim has not drawn."""
    return [[(0,) * 4] * 2 if kind in undrawn else [tuple(int(x) for x in rng.integers(0, f.P, 4)) for _ in range(2)]
            for kind in tape.ELEM_KINDS]


def _witness_comp(comp, n, rng, fill, carry=False):
    tp = tape.record(comp, witness=True)
    main, pp = [_col(rng, n, fill) for _ in comp.MAIN], [_col(rng, n, fill) for _ in comp.PP_IDS]
    out = (tp, main, pp)
    if carry:
        out += (torch.from_numpy(rng.integers(0, f.P, 4).astype(np.int32)),)
    return out


def _schedule(n_tiles: int, rng, mode: str) -> np.ndarray:
    """An order of K5's tile steps (2t: tile t begins, 2t + 1: it ends) as a
    card may run them: tiles begin in the order drawn; a tile ends after it
    began, any time later ("mixed"), at once ("in_order"), or after every
    tile has begun, in a shuffled order ("begins_first")."""
    if mode == "in_order":
        return np.array([s for t in range(n_tiles) for s in (2 * t, 2 * t + 1)], dtype=np.int32)
    ops, pending, begun = [], [], 0
    while begun < n_tiles or pending:
        if begun < n_tiles and (not pending or mode == "begins_first" or rng.random() < 0.6):
            ops.append(2 * begun)
            pending.append(begun)
            begun += 1
        else:
            ops.append(2 * pending.pop(int(rng.integers(len(pending)))) + 1)
    return np.array(ops, dtype=np.int32)


# --- the host build -------------------------------------------------------------

_SHIM = r"""
#define __host__
#define __device__
#define __forceinline__ inline
#include <stdexcept>
#include <vector>
#include "air.cuh"
extern "C" long long h_witness_args_size() { return sizeof(lum::WitnessArgs); }
extern "C" long long h_domain_args_size() { return sizeof(lum::DomainArgs); }
extern "C" long long h_kinds() { return lum::AIR_KINDS; }
// K5's first warp: its 32 lanes in turn.  A look-back never waits here: every
// tile it reads has begun (_schedule), so a wait is a fault.
struct HostWarp {
  template <class F> unsigned ballot(F f) const {
    unsigned m = 0;
    for (int l = 0; l < 32; l++) m |= (f(l) ? 1u : 0u) << l;
    return m;
  }
  template <class F> lum::qm31 sum(F f) const {
    lum::qm31 s = {0u, 0u, 0u, 0u};
    for (int l = 0; l < 32; l++) s = lum::qadd(s, f(l));
    return s;
  }
  template <class F> void lane0(F f) const { f(); }
  void pause() const { throw std::runtime_error("a look-back waits on a tile that has not published"); }
};
// A CTA of T threads, each in turn (a K5 tile: items rounds of them).
struct HostBlock {
  int T;
  template <class F> void each(F f) const { for (int t = 0; t < T; t++) f(t); }
  void sync() const {}
  void scan(lum::qm31* x) const { for (int t = 1; t < T; t++) x[t] = lum::qadd(x[t - 1], x[t]); }
  template <class F> void warp(F f) const { f(HostWarp{}); }
};
// A witness launch's tile steps in the order `ops` gives (_schedule); 1 if
// a look-back waited.
extern "C" int h_witness(const lum::WitnessArgs* a, const int* ops, int n_ops) {
  std::vector<lum::qm31> tot((size_t)a->n_tiles * a->rows), excl(a->n_tiles);
  const HostBlock b{a->rows / a->items};
  try {
    for (int i = 0; i < n_ops; i++) {
      const int t = ops[i] >> 1;
      if (ops[i] & 1) lum::witness_end(b, *a, t, tot.data() + (size_t)t * a->rows, &excl[t]);
      else lum::witness_begin(b, *a, t, tot.data() + (size_t)t * a->rows, &excl[t]);
    }
  } catch (const std::exception&) {
    return 1;
  }
  return 0;
}
// Every CTA of a quotient launch in `order`, each thread of it in turn.
extern "C" void h_domain(const lum::DomainArgs* a, const int* order, int threads) {
  for (int i = 0; i < a->n_ctas; i++)
    for (int t = 0; t < threads; t++) lum::domain_cta_row(*a, order[i], t, threads);
}
"""


def _build(d: Path, texts: dict):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no C++ compiler for the host build of csrc/air.cuh")
    for name in HEADERS:
        (d / name).write_text(texts.get(name, (CSRC / name).read_text()))
    (d / "shim.cpp").write_text(_SHIM)
    subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-I", str(d), "-o", str(d / "air.so"),
                    str(d / "shim.cpp")], check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(d / "air.so"))
    lib.h_witness_args_size.restype = lib.h_domain_args_size.restype = lib.h_kinds.restype = ctypes.c_longlong
    assert lib.h_witness_args_size() == ctypes.sizeof(kernels.WitnessArgs)
    assert lib.h_domain_args_size() == ctypes.sizeof(kernels.DomainArgs)
    assert lib.h_kinds() == len(ALL_COMPONENTS) == len(kernels.compiled_air_tapes()) // 2
    lib.h_witness.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
    lib.h_witness.restype = ctypes.c_int
    lib.h_domain.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
    return lib


@pytest.fixture(scope="module")
def host_air(tmp_path_factory):
    return _build(tmp_path_factory.mktemp("air"), {})


def _host_witness(lib, comps, ew, shape, rng, mode="mixed", epoch=5):
    """kernels.air_witness_many's launch on CPU tensors, tiles of `shape`
    = (threads, items) -- items rounds of `threads` rows -- run by the host
    build in a `_schedule` order, its scratch filled with an earlier
    launch's flags (epoch - 1, every tile's prefix published) and random
    sums, which this launch must not read."""
    kinds, ptrs, _ = kernels._witness_table(comps)
    outs = [torch.full((4 * c[0].n_relations, (list(c[1]) + list(c[2]))[0].shape[0]), -1, dtype=torch.int32)
            for c in comps]
    claimed = torch.full((len(comps), 4), -1, dtype=torch.int32)
    a = kernels._witness_args(comps, kinds, ptrs, ew, outs, claimed, *shape)
    scratch = torch.from_numpy(rng.integers(0, 1 << 31, 2 + 5 * a.n_tiles))
    scratch[2 : 2 + a.n_tiles] = (epoch - 1) << 2 | 2
    p = scratch.data_ptr()
    a.counter, a.flags, a.sums, a.epoch = p, p + 16, p + 16 + 8 * a.n_tiles, epoch
    ops = _schedule(a.n_tiles, rng, mode)
    assert lib.h_witness(ctypes.addressof(a), ops.ctypes.data, len(ops)) == 0, "a look-back waited"
    return outs, claimed


def _host_domain(lib, blocks, ew, threads, rng):
    """kernels.air_domain_many's launch on CPU tensors, CTAs of `threads`
    rows run by the host build in a shuffled order."""
    kinds, ptrs, _ = kernels._domain_table(blocks)
    outs = [torch.full((b.rows, 4), -1, dtype=torch.int32) for b in blocks]
    a = kernels._domain_args(blocks, kinds, ptrs, ew, outs, threads)
    order = rng.permutation(a.n_ctas).astype(np.int32)
    lib.h_domain(ctypes.addressof(a), order.ctypes.data, threads)
    return outs


def _witness_equal(got, comps, ew):
    outs, claimed = got
    want, want_claimed = kernels.air_witness_many_plain(comps, ew)
    return all(torch.equal(g, w) for g, w in zip(outs, want)) and torch.equal(claimed, want_claimed)


# --- K5 ---------------------------------------------------------------------------

# Tiles (threads, rows a thread) of 4 x 1 at 2^0 (one tile, one row), 4 x 2
# at 2^6 (8 tiles) and 2 x 4 at 2^10 (128 tiles: look-backs over several
# 32-tile windows).
WITNESS_SHAPES = {0: (4, 1), 6: (4, 2), 10: (2, 4)}


@pytest.mark.parametrize("fill", ["random", "zeros", "honest"])
@pytest.mark.parametrize("log", [0, 6, 10])
@pytest.mark.parametrize("name", NAMES)
def test_host_witness_equals_the_twin(host_air, name, log, fill):
    rng = np.random.default_rng(NAMES.index(name) + 100 * log + 7 * len(fill))
    ew = _ew(rng)
    comps = [_witness_comp(ALL_COMPONENTS[NAMES.index(name)], 1 << log, rng, fill)]
    got = _host_witness(host_air, comps, ew, WITNESS_SHAPES[log], rng)
    assert _witness_equal(got, comps, ew)
    out, claimed = kernels.air_witness(*comps[0], ew)
    assert torch.equal(out, got[0][0]) and torch.equal(claimed, got[1][0])


@pytest.mark.parametrize("mode", ["in_order", "mixed", "begins_first"])
@pytest.mark.parametrize("shape", [(1, 1), (4, 2), (32, 4)])
def test_host_witness_of_every_component_in_one_launch(host_air, shape, mode):
    """All 18 components in one table, each of its own size (1 to 2^10
    rows), random, zero and honest words mixed, every third with a carry:
    one launch's interactions and (C, 4) claimed sums against the twins,
    component by component, whatever order the tiles end in."""
    rng = np.random.default_rng(shape[0] + shape[1] + len(mode))
    ew = _ew(rng)
    fills = ("random", "zeros", "honest")
    comps = [_witness_comp(c, 1 << int(rng.integers(0, 11)), rng, fills[i % 3], carry=i % 3 == 1)
             for i, c in enumerate(ALL_COMPONENTS)]
    assert _witness_equal(_host_witness(host_air, comps, ew, shape, rng, mode), comps, ew)
    outs, claimed = kernels.air_witness_many(comps, ew)
    assert torch.equal(claimed, kernels.air_witness_many_plain(comps, ew)[1])


def test_host_witness_of_row_blocks_with_carries(host_air):
    """A trace cut into 4 row blocks, each block's last entry started from
    the sum of the blocks before it (its carry), all in one launch: the
    whole trace's interaction, block by block, and its claimed sum."""
    rng = np.random.default_rng(31)
    ew = _ew(rng)
    tp, main, pp = _witness_comp(ALL_COMPONENTS[NAMES.index("mul")], 1 << 10, rng, "random")
    whole, total = tape.witness_plain(tp, main, pp, ew)
    parts = [slice(r << 8, (r + 1) << 8) for r in range(4)]
    comps = [(tp, [c[p] for c in main], [c[p] for c in pp],
              (whole[-4:, p.start - 1] if p.start else torch.zeros(4, dtype=torch.int32)).contiguous())
             for p in parts]
    outs, claimed = _host_witness(host_air, comps, ew, (4, 2), rng, "begins_first")
    assert torch.equal(torch.cat(outs, 1), whole) and torch.equal(claimed[-1], total)


def test_zero_denominators_give_zero_inverses(host_air):
    """An entry whose lookup elements are zero (a kind the claim has not
    drawn) on zero words: d = 0, whose inverse the twin takes as 0; the
    batched inversion must keep it out of the other entries' product."""
    rng = np.random.default_rng(3)
    ew = _ew(rng, undrawn=("node",))
    comps = [_witness_comp(ALL_COMPONENTS[NAMES.index(n)], 1 << 6, rng, "zeros") for n in ("mul", "less_than")]
    assert _witness_equal(_host_witness(host_air, comps, ew, (4, 1), rng), comps, ew)


# --- K6 ---------------------------------------------------------------------------


def _domain_term(comp, m, rng, fill, ew, pows_from=None):
    """One component's columns on a domain of m rows: random words, zeros,
    or small words (0 to 2) with the interaction K5's twin builds from
    them; is_first random, or the first row's."""
    tp = tape.record(comp)
    main, pp = [_col(rng, m, fill) for _ in comp.MAIN], [_col(rng, m, fill) for _ in comp.PP_IDS]
    if fill == "honest":
        inter, claimed = tape.witness_plain(tape.record(comp, witness=True), main, pp, ew)
        inter, claimed = list(inter.unbind(0)), tuple(int(x) for x in claimed)
    else:
        inter, claimed = [_col(rng, m, fill) for _ in range(4 * tp.n_relations)], tuple(
            int(x) for x in rng.integers(0, f.P, 4))
    is_first = _col(rng, m, "random") if fill == "random" else torch.zeros(m, dtype=torch.int32)
    if fill != "random":
        is_first[0] = 1
    start, alpha = pows_from or [tuple(int(x) for x in rng.integers(0, f.P, 4)) for _ in range(2)]
    pows, nxt = f.qm31_powers_ints(start, alpha, tp.n_pows)
    return kernels.DomainTerm(tp, main, pp, [c.contiguous() for c in inter], is_first, claimed, pows), nxt


def _row_blocks(blk: kernels.DomainBlock, shards: int) -> list:
    """The block's domain cut into `shards` row blocks, each with its halo
    from its neighbours (wrapping at the domain's ends)."""
    m, stride = blk.rows, blk.stride
    R = m // shards
    out = []
    for r in range(shards):
        part, nxt0, prev0 = slice(r * R, (r + 1) * R), ((r + 1) % shards) * R, (r * R - stride) % m
        terms = [kernels.DomainTerm(t.tp, [c[part] for c in t.main], [c[part] for c in t.pp],
                                    [c[part] for c in t.inter], t.is_first[part], t.claimed, t.pows,
                                    ({x: t.main[x][nxt0 : nxt0 + stride] for x in t.tp.next_cols},
                                     [c[prev0 : prev0 + stride] for c in t.inter[-4:]])) for t in blk.terms]
        out.append(kernels.DomainBlock(terms, blk.log_trace, stride, r * R, _log(m)))
    return out


def _log(m: int) -> int:
    return m.bit_length() - 1


def _shard_launches(blocks: list, shards: int = 4) -> list:
    """The launches of a mesh's row shards for a prove-like table (the
    largest log last): each shard's row block of the largest log's
    domain, and on the first (the lead) also every other domain whole."""
    rows = _row_blocks(blocks[-1], shards)
    return [[rows[0]] + blocks[:-1]] + [[b] for b in rows[1:]]


# Trace logs 1, 6 and 10 at blowups 1, 2 and 1 (strides 2, 4, 2): domains
# of 4, 256 and 2048 rows; CTAs of 4, 16 and 64 rows.
DOMAIN_CASES = {1: (1, 4), 6: (2, 16), 10: (1, 64)}


@pytest.mark.parametrize("fill", ["random", "zeros", "honest"])
@pytest.mark.parametrize("log", [1, 6, 10])
@pytest.mark.parametrize("name", NAMES)
def test_host_domain_equals_the_twin(host_air, name, log, fill):
    """One component on its whole commit domain, then the same domain as
    row blocks with their halos (2 or 4), every block in one launch:
    the twin's quotients, word for word."""
    rng = np.random.default_rng(1000 + NAMES.index(name) + 100 * log + 7 * len(fill))
    ew = _ew(rng)
    blowup, threads = DOMAIN_CASES[log]
    m = 1 << (log + blowup)
    term, _ = _domain_term(ALL_COMPONENTS[NAMES.index(name)], m, rng, fill, ew)
    blk = kernels.DomainBlock([term], log, 1 << blowup)
    want = kernels.air_domain_many_plain([blk], ew)[0]
    assert torch.equal(_host_domain(host_air, [blk], ew, threads, rng)[0], want)
    blocks = _row_blocks(blk, 2 if log == 1 else 4)
    assert torch.equal(torch.cat(_host_domain(host_air, blocks, ew, threads, rng)), want)
    assert torch.equal(torch.cat(kernels.air_domain_many_plain(blocks, ew)), want)


def _prove_like(rng, ew, logs: dict, fill: str, blowup: int):
    """Every component on the commit domain of its trace log (`logs`), in
    one table as a prove's would be: a block a trace log with its
    components in ALL_COMPONENTS order, the alpha powers running on from
    one component to the next."""
    start, alpha = [tuple(int(x) for x in rng.integers(0, f.P, 4)) for _ in range(2)]
    by_log = {}
    for comp in ALL_COMPONENTS:
        term, start = _domain_term(comp, 1 << (logs[comp.name] + blowup), rng, fill, ew, (start, alpha))
        by_log.setdefault(logs[comp.name], []).append(term)
    return [kernels.DomainBlock(terms, log, 1 << blowup) for log, terms in sorted(by_log.items())]


@pytest.mark.parametrize("fill", ["random", "honest"])
@pytest.mark.parametrize("blowup", [1, 2])
def test_host_domain_of_every_component_in_one_launch(host_air, blowup, fill):
    """All 18 components in one launch, grouped by trace log (1 to 7) into
    blocks of several components, each block's sum of the twins'
    quotients; then the largest log's blocks as 4 row shards' blocks with
    halos beside the other logs' whole domains (a mesh's lead shard)."""
    rng = np.random.default_rng(50 + blowup + len(fill))
    ew = _ew(rng)
    logs = {c.name: int(rng.integers(1, 7)) for c in ALL_COMPONENTS}
    logs["mul"] = logs["max_reduce"] = logs["sum_reduce"] = 7
    blocks = _prove_like(rng, ew, logs, fill, blowup)
    assert max(len(b.terms) for b in blocks) >= 3
    want = kernels.air_domain_many_plain(blocks, ew)
    got = _host_domain(host_air, blocks, ew, 16, rng)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    lead, *rest = _shard_launches(blocks)
    got = _host_domain(host_air, lead, ew, 16, rng)
    blocks_got = [got[0]] + [_host_domain(host_air, launch, ew, 16, rng)[0] for launch in rest]
    assert torch.equal(torch.cat(blocks_got), want[-1])
    assert all(torch.equal(g, w) for g, w in zip(got[1:], want[:-1]))


# --- the wrappers' refusals ---------------------------------------------------


def test_the_wrappers_refuse_a_tape_that_is_not_compiled():
    rng = np.random.default_rng(1)
    ew = _ew(rng)
    comp = ALL_COMPONENTS[NAMES.index("mul")]
    tp, main, pp = _witness_comp(comp, 8, rng, "random")
    renamed = tape.Tape("not_a_component", tp.words, tp.n_regs, 0, tp.n_relations, tp.n_main, tp.n_pp)
    with pytest.raises(KernelError, match="no compiled witness tape"):
        kernels.air_witness_many([(tp, main, pp), (renamed, main, pp)], ew)
    with pytest.raises(KernelError, match="a witness tape"):
        kernels.air_witness(tape.record(comp), main, pp, ew)
    term, _ = _domain_term(comp, 8, rng, "random", ew)
    wider = tape.Tape(term.tp.name, term.tp.words, term.tp.n_regs, term.tp.n_constraints, term.tp.n_relations,
                      term.tp.n_main + 1, term.tp.n_pp)
    with pytest.raises(KernelError, match="no compiled domain tape"):
        kernels.air_domain(wider, term.main + [term.main[0]], term.pp, term.inter, term.is_first, term.claimed, ew,
                           term.pows, 2, 2)
    with pytest.raises(KernelError, match="no compiled domain tape"):
        kernels.air_domain(tape.record(comp, witness=True), term.main, term.pp, term.inter, term.is_first,
                           term.claimed, ew, term.pows[:3], 2, 2)


def test_the_wrappers_refuse_what_a_launch_cannot_take():
    rng = np.random.default_rng(2)
    ew = _ew(rng)
    comp = ALL_COMPONENTS[NAMES.index("less_than")]
    with pytest.raises(KernelError, match="components"):
        kernels.air_witness_many([_witness_comp(comp, 2, rng, "zeros")] * (kernels.AIR_MAX_COMPS + 1), ew)
    with pytest.raises(KernelError, match="columns"):
        kernels.air_witness_many([_witness_comp(comp, 2, rng, "zeros")] * (kernels.AIR_MAX_COLS // 22 + 1), ew)
    a = _witness_comp(comp, 8, rng, "zeros")
    with pytest.raises(KernelError, match="one device"):
        kernels.air_witness_many([a, _witness_comp(comp, 8, rng, "zeros")[:1] + ([c.to("meta") for c in a[1]], [])],
                                 ew)
    term, _ = _domain_term(ALL_COMPONENTS[NAMES.index("max_reduce")], 16, rng, "random", ew)
    blk = kernels.DomainBlock([term] * 12, 3, 2)
    with pytest.raises(KernelError, match="columns"):
        kernels.air_domain_many([blk], ew)
    halo = _row_blocks(kernels.DomainBlock([term], 3, 2), 2)[0]
    with pytest.raises(KernelError, match="a halo, or none"):
        kernels.air_domain_many([kernels.DomainBlock([halo.terms[0], term], 3, 2)], ew)
    with pytest.raises(KernelError, match="a halo has"):
        kernels.air_domain(term.tp, term.main, term.pp, term.inter, term.is_first, term.claimed, ew, term.pows, 3, 2,
                           halo=({}, halo.terms[0].halo[1]))
    with pytest.raises(KernelError, match="stride"):
        kernels.air_domain(term.tp, term.main, term.pp, term.inter, term.is_first, term.claimed, ew, term.pows, 3, 16)


# --- mutations ------------------------------------------------------------------

# Each breaks one rule of K5 or K6 (file, text, replacement); the host
# build must then disagree with the twins somewhere on the data of
# `_mutation_data`.
MUTATIONS = {
    "epoch ignored": ("air.cuh", "(f >> 2) == a.epoch ?", "true ?"),
    "carry ignored": ("air.cuh", "c.carry ? qload((const uint32_t*)c.carry) :", "false ? qm31{} :"),
    "look-back takes the prefix alone": ("air.cuh", "if (l > stop || j - l < first)", "if (l != stop || j - l < first)"),
    "look-back of one window": ("air.cuh", "    if (pre) return excl;\n", "    return excl;\n"),
    "inversion without its prefix products": ("air.cuh", "ninv[b] = mul(t, pre[b - 1]);", "ninv[b] = t;"),
    "zero norms in the product": ("air.cuh", "norm[b] = nb + (1u - nonzero(nb));", "norm[b] = nb;"),
    "tiles a row late": ("air.cuh", "(long long)(t - c.tile0) * a.rows + (long long)i * T",
                         "(long long)(t - c.tile0) * a.rows + (long long)i * T + 1"),
    "V_n a squaring short": ("air.cuh", "i < s.log_trace - 1;", "i < s.log_trace - 2;"),
    "next row a row on": ("air.cuh", "r, r + s.stride, r - s.stride, s.n}", "r, r + 1, r - s.stride, s.n}"),
    "no claimed sum": ("tape_row.cuh", "qmul_m31(qload(claimed), at(First))", "qmul_m31(qload(claimed), 0u)"),
}


def _mutation_data(rng):
    """Every component's witness at 2^8 rows (tiles of 2 x 2, the ends
    shuffled after every begin; one with a carry; mul and less_than on
    zero words against zero `node` elements) and its quotients in the
    launches of a prove-like table's 4 row shards (`_shard_launches`)."""
    ew = _ew(rng, undrawn=("node",))
    comps = [_witness_comp(c, 1 << 8, rng, "zeros" if c.name in ("mul", "less_than") else "honest",
                           carry=c.name == "add") for c in ALL_COMPONENTS]
    logs = {c.name: 3 + i % 2 for i, c in enumerate(ALL_COMPONENTS)}
    logs["mul"] = logs["max_reduce"] = logs["sum_reduce"] = 5
    return ew, comps, _shard_launches(_prove_like(rng, ew, logs, "honest", 2))


def _waits(lib, rng, stale: bool) -> bool:
    """Whether a tile's look-back waits for tile 0 of its launch, which has
    not published yet (tile 1 begun and ended first), where the scratch
    holds an earlier launch's prefixes (stale) or zeros."""
    comps = [_witness_comp(ALL_COMPONENTS[NAMES.index("mul")], 8, rng, "random")]
    kinds, ptrs, _ = kernels._witness_table(comps)
    outs, claimed = [torch.zeros((12, 8), dtype=torch.int32)], torch.zeros((1, 4), dtype=torch.int32)
    a = kernels._witness_args(comps, kinds, ptrs, _ew(rng), outs, claimed, 4, 1)
    scratch = torch.zeros(2 + 5 * a.n_tiles, dtype=torch.int64)
    if stale:
        scratch[2 : 2 + a.n_tiles] = 6 << 2 | 2
    p = scratch.data_ptr()
    a.counter, a.flags, a.sums, a.epoch = p, p + 16, p + 16 + 8 * a.n_tiles, 7
    ops = np.array([2, 3], dtype=np.int32)
    return lib.h_witness(ctypes.addressof(a), ops.ctypes.data, len(ops)) == 1


@pytest.mark.parametrize("stale", [False, True])
def test_a_look_back_waits_for_a_tile_that_has_not_published(host_air, stale):
    assert _waits(host_air, np.random.default_rng(4), stale)


def _all_equal(lib, rng, ew, comps, launches) -> bool:
    w = _witness_equal(_host_witness(lib, comps, ew, (2, 2), rng, "begins_first"), comps, ew)
    d = all(torch.equal(g, p) for blocks in launches
            for g, p in zip(_host_domain(lib, blocks, ew, 8, rng), kernels.air_domain_many_plain(blocks, ew)))
    return w and d and _waits(lib, rng, True)


def test_the_mutation_data_passes_unmutated(host_air):
    rng = np.random.default_rng(11)
    assert _all_equal(host_air, rng, *_mutation_data(rng))


@pytest.mark.parametrize("mutation", sorted(MUTATIONS))
def test_mutated_kernels_fail(tmp_path, mutation):
    name, old, new = MUTATIONS[mutation]
    text = (CSRC / name).read_text()
    assert old in text
    lib = _build(tmp_path, {name: text.replace(old, new)})
    rng = np.random.default_rng(11)
    assert not _all_equal(lib, rng, *_mutation_data(rng))


# Generators that write a subtraction as an addition, or number the
# quotients' alpha powers of the LogUp constraints from 0: the header they
# write gives other words.
GENERATOR_MUTATIONS = {
    "sub as add": lambda mp: mp.setattr(tape_cuda, "_BINARY", {**tape_cuda._BINARY, tape.OP_SUB: "add"}),
    "LogUp powers from 0": lambda mp: mp.setattr(tape_cuda, "domain_function", _powers_from_zero),
}
_DOMAIN_FUNCTION = tape_cuda.domain_function


def _powers_from_zero(tp):
    return [re.sub(r"qload\(pw\[(\d+)\]\)\)\);$", lambda m: f"qload(pw[{int(m.group(1)) - tp.n_constraints}])));",
                   line) if "logup_value" in line else line for line in _DOMAIN_FUNCTION(tp)]


@pytest.mark.parametrize("mutation", sorted(GENERATOR_MUTATIONS))
def test_mutated_generator_fails(tmp_path, monkeypatch, mutation):
    GENERATOR_MUTATIONS[mutation](monkeypatch)
    text = tape_cuda.generate_air()
    assert text != (CSRC / kernels.AIR_TAPES_HEADER).read_text()
    lib = _build(tmp_path, {kernels.AIR_TAPES_HEADER: text})
    rng = np.random.default_rng(12)
    assert not _all_equal(lib, rng, *_mutation_data(rng))


def test_rows_a_thread_grow_with_the_launch():
    """A launch keeps its tiles to fill the card while it is small, and
    takes more rows a thread (fewer look-backs) as it grows."""
    assert [kernels.witness_items(1 << log) for log in (0, 16, 17, 18, 20, 21, 23)] == [1, 1, 2, 2, 4, 4, 4]
    assert all(kernels.witness_items(n) <= kernels.WITNESS_MAX_ITEMS for n in (1 << 30, 7 << 25))
