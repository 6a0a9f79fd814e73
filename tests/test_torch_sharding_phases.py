"""The AIR and FRI phases of luminair_tpu_torch on row shards, each against
its one-device form and the reference package's device program on the CPU:
K5's witness split into row blocks with carries, K6 on row blocks with
halos, K4's per-shard plans, the FRI chain on row shards with its layers'
trees sharded; then whole proves under meshes the other file does not
use, and the bytes a prove gathers onto the lead against the formula of
parallel/sharding.py.  Meshes repeat the CPU device (n shards on one
device).  Inputs come from numpy seeds; tolerance 0 throughout."""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from luminair_tpu import circle as ref_circle
from luminair_tpu.air import framework as ref_fw
from luminair_tpu.air.components import ALL_COMPONENTS as REF_COMPONENTS
from luminair_tpu.fields import m31 as ref_m31
from luminair_tpu.fields import qm31 as ref_qm31
from luminair_tpu.parallel import accel
from luminair_tpu_torch import circle, kernels, serde
from luminair_tpu_torch import fields as f
from luminair_tpu_torch import prelude as T
from luminair_tpu_torch.air import tape
from luminair_tpu_torch.air.components import ALL_COMPONENTS
from luminair_tpu_torch.air.framework import LookupElements
from luminair_tpu_torch.air.layout import AirLayout
from luminair_tpu_torch.crypto.merkle import MerkleTree, ShardedMerkleTree
from luminair_tpu_torch.errors import ProverError
from luminair_tpu_torch.parallel import sharding as S
from luminair_tpu_torch.pcs import fri
from luminair_tpu_torch.pcs import quotients as q
from tests.test_torch_channel import _low_degree_inputs
from tests.test_torch_quotient import _groups
from tests.test_torch_sharding import _ab_graph, _all_ops, _check_mesh_proof, _config

P = (1 << 31) - 1
CPU = torch.device("cpu")
SHARDS = [2, 4, 8]
# Components with K6's halos: sum_reduce and max_reduce read the next row.
NAMES = ["mul", "sum_reduce", "max_reduce"]
# The reference's jitted programs take seconds to compile on XLA-CPU: one
# component, one blowup and one fold count go through them, the rest
# through the host code they trace.
JITTED = "sum_reduce"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def host_reference():
    was = accel.enabled()
    accel.enable(False)
    yield
    accel.enable(was)


def _mesh(n):
    return S.make_chip_mesh(n, devices=[CPU] * n)


def _split(mesh, t):
    """RowBlocks of a whole (N,) column."""
    rows = t.shape[0] // mesh.size
    return S.RowBlocks(mesh, [t[r * rows : (r + 1) * rows].clone() for r in range(mesh.size)])


def _words(rng, *shape):
    return rng.integers(0, P, size=shape, dtype=np.int64).astype(np.uint32)


def _elements(rng):
    sizes = {"node": 2, "sin": 2, "exp2": 2, "log2": 2, "range_check": 1}
    return {k: (_words(rng, 4), _words(rng, 4), s) for k, s in sizes.items()}


def _pair(name):
    return (next(c for c in ALL_COMPONENTS if c.name == name), next(c for c in REF_COMPONENTS if c.name == name))


def _port_elems(raw):
    return tape.element_words({k: LookupElements(f.u32_to_tensor(z, dtype=f.I64), f.u32_to_tensor(a, dtype=f.I64), s)
                               for k, (z, a, s) in raw.items()})


# --- K5: the witness on row blocks with a carry ------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_witness_on_row_blocks_with_carries(name):
    """The twin on 2, 4 and 8 row blocks, each started from the sum of the
    blocks before it, equals the whole-column twin and the reference's
    `accel.witness_interaction`; so does sharding.air_witness_many (the
    blocks on a mesh's row shards, the totals' exchange, the carry pass)."""
    comp, ref = _pair(name)
    rng = np.random.default_rng(NAMES.index(name))
    n = 1 << 6
    main = {c: _words(rng, n) for c in comp.MAIN}
    pp = {p: _words(rng, n) for p in comp.PP_IDS}
    raw = _elements(rng)
    elems = {k: ref_fw.LookupElements(z, a, s) for k, (z, a, s) in raw.items()}
    if name == JITTED:
        ref_cols, ref_claimed = accel.witness_interaction(ref, main, pp, elems)
    else:  # the host interpreter that the jitted program traces
        wev = ref_fw.WitnessEval(main, pp)
        ref.evaluate(wev, elems)
        ref_cols, ref_claimed = wev.build_interaction()
    expect = np.concatenate([np.asarray(c, dtype=np.uint32).T for c in ref_cols])

    tp, ew = tape.record(comp, witness=True), _port_elems(raw)
    cols = [f.u32_to_tensor(main[c]) for c in comp.MAIN]
    pcols = [f.u32_to_tensor(pp[p]) for p in comp.PP_IDS]
    whole, claimed = tape.witness_plain(tp, cols, pcols, ew)
    assert np.array_equal(f.tensor_to_u32(whole), expect)
    assert np.array_equal(f.tensor_to_u32(claimed), np.asarray(ref_claimed, dtype=np.uint32))
    for shards in SHARDS:
        rows, carry, blocks = n // shards, torch.zeros(4, dtype=f.I32), []
        for r in range(shards):
            part = slice(r * rows, (r + 1) * rows)
            out, carry = kernels.air_witness(tp, [c[part] for c in cols], [c[part] for c in pcols], ew, carry)
            blocks.append(out)
        assert torch.equal(torch.cat(blocks, 1), whole) and torch.equal(carry, claimed)
        got, got_claimed = S.air_witness_many(_mesh(shards), [(tp, cols, pcols)], ew)[0]
        assert isinstance(got, S.RowBlocks) and torch.equal(S.on_lead(got), whole)
        assert torch.equal(got_claimed, claimed)


@pytest.mark.parametrize("shards", SHARDS)
def test_witness_of_every_component_with_one_carry_pass_a_shard(shards):
    """sharding.air_witness_many over n row shards, several components in
    one call (one of 4 rows: at 8 shards it has fewer rows than shards and
    stays on the lead): each interaction and claimed sum the reference's
    `WitnessEval.build_interaction` (the host code the jitted program
    traces), the totals gathered in one copy a shard, one carry pass
    call a shard after the first over every sharded component's block."""
    rng = np.random.default_rng(40 + shards)
    raw = _elements(rng)
    elems = {k: ref_fw.LookupElements(z, a, s) for k, (z, a, s) in raw.items()}
    ew = _port_elems(raw)
    comps, want = [], []
    for name, n in (("mul", 1 << 6), ("sum_reduce", 1 << 5), ("inputs", 4), ("exp2_lookup", 1 << 6)):
        comp, ref = _pair(name)
        main = {c: _words(rng, n) for c in comp.MAIN}
        pp = {p: _words(rng, n) for p in comp.PP_IDS}
        wev = ref_fw.WitnessEval(main, pp)
        ref.evaluate(wev, elems)
        ref_cols, ref_claimed = wev.build_interaction()
        want.append((np.concatenate([np.asarray(c, dtype=np.uint32).T for c in ref_cols]),
                     np.asarray(ref_claimed, dtype=np.uint32)))
        comps.append((tape.record(comp, witness=True), [f.u32_to_tensor(main[c]) for c in comp.MAIN],
                      [f.u32_to_tensor(pp[p]) for p in comp.PP_IDS]))
    carries = []
    real = kernels.add_carry

    def add_carry(rows, carry):
        carries.append((len(rows), tuple(carry.shape)))
        return real(rows, carry)

    try:
        kernels.add_carry = add_carry
        got = S.air_witness_many(_mesh(shards), comps, ew)
    finally:
        kernels.add_carry = real
    sharded = 3 if shards == 8 else 4
    assert carries == [(sharded, (sharded, 4))] * (shards - 1)
    for (out, claimed), (cols, total) in zip(got, want, strict=True):
        assert np.array_equal(f.tensor_to_u32(S.on_lead(out)), cols)
        assert np.array_equal(f.tensor_to_u32(claimed), total)
    assert isinstance(got[2][0], S.RowBlocks) == (shards < 8)


def test_add_carry_adds_one_word_a_coordinate():
    rows = torch.arange(12, dtype=torch.int32).reshape(4, 3)
    kernels.add_carry(rows, torch.tensor([1, 2, 3, P - 1], dtype=torch.int32))
    assert rows.tolist() == [[1, 2, 3], [5, 6, 7], [9, 10, 11], [8, 9, 10]]


# --- K6: row blocks with halos ----------------------------------------------


@pytest.mark.parametrize("log_blowup", [1, 2])
@pytest.mark.parametrize("name", NAMES)
def test_domain_on_row_blocks_with_halos(name, log_blowup):
    """sharding.air_domain_many over 2, 4 and 8 row shards (each block's
    halo from its neighbours, wrapping at both ends) equals the whole-
    domain twin and the reference's `accel.domain_constraints`, also
    after a whole domain on the lead in the same call; the twin on one
    block with its halo equals that block of the whole."""
    comp, ref = _pair(name)
    rng = np.random.default_rng(100 + NAMES.index(name) + 10 * log_blowup)
    log = 5
    m = 1 << (log + log_blowup)
    main = {c: _words(rng, m) for c in comp.MAIN}
    pp = {p: _words(rng, m) for p in comp.PP_IDS}
    inter = [_words(rng, m, 4) for _ in range(comp.N_INTERACTION)]
    is_first, claimed, alpha, acc_pow = _words(rng, m), _words(rng, 4), _words(rng, 4), _words(rng, 4)
    raw = _elements(rng)
    elems = {k: ref_fw.LookupElements(z, a, s) for k, (z, a, s) in raw.items()}
    if name == JITTED and log_blowup == 2:
        want, _ = accel.domain_constraints(ref, log + log_blowup, log, main, pp, inter, is_first, claimed, alpha,
                                           acc_pow, elems, roll_stride=1 << log_blowup)
    else:  # DomainEval and the division by the vanishing polynomial, as the jitted program traces them
        acc = ref_fw.ConstraintAccumulator(alpha, (m,))
        acc._pow = acc_pow
        ref.evaluate(ref_fw.DomainEval(main, pp, inter, is_first, claimed, acc, roll_stride=1 << log_blowup), elems)
        xs, _ = ref_circle.domain_points(log + log_blowup)
        want = ref_m31.mul(acc.acc, ref_m31.inv(ref_circle.coset_vanishing_eval(xs, log, log + log_blowup))[:, None])

    tp, ew = tape.record(comp), _port_elems(raw)
    pows, _ = f.qm31_powers_ints(f.qm31_words(acc_pow), f.qm31_words(alpha), tp.n_pows)
    args = ([f.u32_to_tensor(main[c]) for c in comp.MAIN], [f.u32_to_tensor(pp[p]) for p in comp.PP_IDS],
            [f.u32_to_tensor(np.ascontiguousarray(e[:, k])) for e in inter for k in range(4)],
            f.u32_to_tensor(is_first))
    stride = 1 << log_blowup
    whole = tape.domain_plain(tp, *args, f.qm31_words(claimed), ew, pows, log, stride)
    assert np.array_equal(f.tensor_to_u32(whole), np.asarray(want, dtype=np.uint32))
    for shards in SHARDS:
        mesh = _mesh(shards)
        main_b, pp_b, inter_b = ([_split(mesh, c) for c in args[i]] for i in range(3))
        first_b = _split(mesh, args[3])
        rows = ([(tp, main_b, pp_b, inter_b, first_b, claimed, pows)], log, stride)
        got, = S.air_domain_many(mesh, [rows], ew)
        assert torch.equal(S.on_lead(got), whole), shards
        on_lead = ([(tp, *args, claimed, pows)], log, stride)
        lead, got = S.air_domain_many(mesh, [on_lead, rows], ew)
        assert torch.equal(lead, whole) and torch.equal(S.on_lead(got), whole), shards
        # The last block alone: its halo wraps to the domain's first rows.
        rows, r = m // shards, shards - 1
        part = slice(r * rows, (r + 1) * rows)
        halo = ({x: args[0][x][:stride] for x in tp.next_cols},
                [c[r * rows - stride : r * rows] for c in args[2][-4:]])
        block = kernels.air_domain(tp, [c[part] for c in args[0]], [c[part] for c in args[1]],
                                   [c[part] for c in args[2]], args[3][part], claimed, ew, pows, log, stride,
                                   row0=r * rows, log_domain=log + log_blowup, halo=halo)
        assert torch.equal(block, whole[part])


def test_domain_block_smaller_than_its_halo_raises():
    comp, _ = _pair("sum_reduce")
    tp = tape.record(comp)
    mesh = _mesh(8)
    col = _split(mesh, torch.zeros(8, dtype=torch.int32))  # one row a shard, a halo of 2
    term = (tp, [col] * tp.n_main, [col] * tp.n_pp, [col] * (4 * tp.n_relations), col, (0, 0, 0, 0),
            [(1, 0, 0, 0)] * tp.n_pows)
    with pytest.raises(ProverError):
        S.air_domain_many(mesh, [([term], 2, 2)], tape.element_words({}))


@pytest.mark.parametrize("shards", SHARDS)
def test_domain_groups_whole_on_the_lead_between_row_sharded_ones(shards):
    """sharding.air_domain_many over groups in a prove's order where whole
    domains on the lead (traces of fewer rows than shards) come before and
    between row-sharded ones: each group's quotients equal the one-device
    launch's (kernels.air_domain_many) of the same domains."""
    rng = np.random.default_rng(70 + shards)
    mesh, ew = _mesh(shards), _port_elems(_elements(rng))
    start, alpha = (tuple(int(w) for w in _words(rng, 4)) for _ in range(2))
    groups, whole = [], []
    for name, log, sharded in [("add", 2, False), ("mul", 5, True), ("recip", 1, False), ("sum_reduce", 6, True),
                               ("max_reduce", 4, True)]:
        comp = next(c for c in ALL_COMPONENTS if c.name == name)
        tp, m, stride = tape.record(comp), 1 << (log + 1), 2
        cols = [f.u32_to_tensor(_words(rng, m)) for _ in range(tp.n_main + tp.n_pp + 4 * tp.n_relations + 1)]
        main, pp = cols[: tp.n_main], cols[tp.n_main : tp.n_main + tp.n_pp]
        inter, is_first = cols[tp.n_main + tp.n_pp : -1], cols[-1]
        mine, start = f.qm31_powers_ints(start, alpha, tp.n_pows)
        claimed = tuple(int(w) for w in _words(rng, 4))
        whole.append(kernels.DomainBlock([kernels.DomainTerm(tp, main, pp, inter, is_first, claimed, mine)],
                                         log, stride))
        if sharded:
            main, pp, inter = ([_split(mesh, c) for c in cs] for cs in (main, pp, inter))
            is_first = _split(mesh, is_first)
        groups.append(([(tp, main, pp, inter, is_first, claimed, mine)], log, stride))
    want = kernels.air_domain_many(whole, ew)
    got = S.air_domain_many(mesh, groups, ew)
    assert [isinstance(g, S.RowBlocks) for g in got] == [False, True, False, True, True]
    assert all(torch.equal(S.on_lead(g), w) for g, w in zip(got, want))


# --- K4: a plan a row shard -------------------------------------------------


@pytest.mark.parametrize("shards", SHARDS)
def test_quotient_plans_per_row_shard(shards):
    """Each shard's plan over its row blocks (domain tables from the block's
    first row) equals that block of the one-device twin's quotients and of
    the reference's `accel.quotient_group`, the groups of a log added."""
    groups = [g for g in _groups("several logs") if g[0] >= 4]  # logs 4..6: a row a shard at 8 shards
    whole = kernels.deep_quotient_many_plain(kernels.QuotientPlan(groups))
    ref = {}
    for log, cols, gs, consts in groups:
        if log != 6:  # one log through the reference's program (its compile per shape takes seconds)
            continue
        got = np.asarray(accel.quotient_group(log, [f.tensor_to_u32(c) for c in cols], list(gs.astype(np.uint32)),
                                              *consts.astype(np.uint32)))
        ref[log] = ref_qm31.add(ref[log], got) if log in ref else got
    s = shards.bit_length() - 1
    parts = []
    for r in range(shards):
        plan = kernels.QuotientPlan([(log, [c.chunk(shards)[r].contiguous() for c in cols], g, k)
                                     for log, cols, g, k in groups], shard=(r, s))
        assert plan.n_rows == sum(1 << (log - s) for log in plan.rows)
        parts.append(kernels.deep_quotient_many(plan))
    for log in whole:
        got = torch.cat([p[log] for p in parts])
        assert torch.equal(got, whole[log])
    assert np.array_equal(f.tensor_to_u32(torch.cat([p[6] for p in parts])), ref[6])


def test_accumulate_quotients_on_row_shards():
    """pcs/quotients.accumulate_quotients with the columns of logs >= s as
    RowBlocks and the rest on the lead gives the one-device sums."""
    mesh = _mesh(4)
    rng = np.random.default_rng(3)
    pt = circle.point_from_t_qm31(torch.from_numpy(rng.integers(0, P, 4)))
    samples, whole, shard = [], {}, {}
    for i, log in enumerate([6, 1, 5, 6, 2]):
        col = torch.from_numpy(rng.integers(0, P, 1 << log).astype(np.int32))
        whole[(0, i)] = col
        shard[(0, i)] = _split(mesh, col) if log >= 2 else col
        samples.append(q.ColumnSample(log, 0, i, pt, rng.integers(0, P, 4).astype(np.uint32)))
    gamma = torch.from_numpy(rng.integers(0, P, 4))
    want = q.accumulate_quotients(samples, whole, gamma)
    got = q.accumulate_quotients(samples, shard, gamma)
    assert sorted(got) == sorted(want)
    for log in want:
        assert isinstance(got[log], S.RowBlocks) == (log >= 2)
        assert torch.equal(S.on_lead(got[log]), want[log])


# --- K3 and the FRI layers' trees on row shards ------------------------------

_REF_CHAIN = {}


@pytest.mark.parametrize("folds", [1, 2, 3])
@pytest.mark.parametrize("shards", SHARDS)
def test_commit_chain_on_row_shards(shards, folds):
    """fri.commit_chain with its inputs as RowBlocks over 2, 4 and 8 row
    shards: the reference chain's final state, roots, alphas, alpha0 and
    last layer; every layer whose folds have a row a shard holds a
    ShardedMerkleTree whose root is a plain MerkleTree's; the bytes
    gathered are the formula's FRI part."""
    logs, B, bound = (8, 7, 5, 4), 1, 1
    inputs = _low_degree_inputs(logs, folds)
    digest = np.random.default_rng(9).integers(0, P, 8).astype("<u4").tobytes()
    if folds == 2:  # the reference's chain (one compile); the port's one-device chain, which
        # tests/test_torch_channel.py holds against it, for the others
        ref = _REF_CHAIN.get(folds) or _REF_CHAIN.setdefault(
            folds, accel.fri_commit_chain(inputs, B, bound, folds, B + bound, digest, 3))
    else:
        one = fri.commit_chain({k: f.u32_to_tensor(v) for k, v in inputs.items()}, B + bound, folds, digest, 3)
        ref = one[:5] + (f.tensor_to_u32(one[5]),)
    mesh = _mesh(shards)
    rows = {k: S.RowBlocks(mesh, [b.clone() for b in f.u32_to_tensor(v).chunk(shards)], 0) for k, v in inputs.items()}
    S.reset_bytes()
    got = fri.commit_chain(rows, B + bound, folds, digest, 3)
    gathered = S.BYTES["gathered"]
    assert got[0] == ref[0] and got[1] == ref[1]
    for a, b in zip(got[2] + got[3], ref[2] + ref[3], strict=True):
        assert np.array_equal(a, np.asarray(b, dtype=np.uint32))
    assert np.array_equal(got[4], ref[4])
    assert np.array_equal(f.tensor_to_u32(got[5]), ref[5])
    sharded = 0
    for log, evals, tree in got[6]:
        whole = S.on_lead(evals)
        assert np.array_equal(tree.root, MerkleTree({log: whole.t()}).root)
        sharded += isinstance(tree, ShardedMerkleTree) and isinstance(evals, S.RowBlocks)
    assert sharded == sum(1 for log, fl in fri.layer_schedule(8, B + bound, folds) if 1 << (log - fl) >= shards)
    cfg = T.FriConfig(log_blowup_factor=B, log_last_layer_degree_bound=bound, folds_per_layer=folds)
    assert gathered == S.expected_gathered_bytes(shards, [[l - B for l in logs]], B, cfg)


def test_mirror_runs_pair_as_the_global_layer():
    """Laid out in the runs' order, a block's rows pair (i, N - 1 - i) as
    the whole layer's rows (j, N - 1 - j) do, fold after fold."""
    size_log, folds, m = 6, 3, 2
    for a in range(0, (1 << size_log) >> folds, m):
        runs = fri._mirror_runs(size_log, folds, a, m)
        for t in range(folds):
            idx = np.concatenate([np.arange(st, st + m) for st in runs[t]])
            nxt = np.concatenate([np.arange(st, st + m) for st in runs[t + 1]])
            half = len(idx) // 2
            assert np.array_equal(idx[:half], nxt)
            assert np.array_equal(idx[::-1][:half], (1 << (size_log - t)) - 1 - nxt)


# --- whole proves ------------------------------------------------------------


@pytest.mark.parametrize("shape", [(2, 2), (4, 2)])
def test_rows_cols_mesh_prove_matches_reference(shape, host_reference):
    r, c = shape
    _check_mesh_proof(lambda pkg: _ab_graph(pkg, 16, 31), S.make_mesh(r * c, shape, devices=[CPU] * (r * c)))


@pytest.mark.parametrize("n_dev", SHARDS)
def test_sharded_prove_at_blowup_2_matches_reference(n_dev, host_reference):
    _check_mesh_proof(lambda pkg: _ab_graph(pkg, 8, 7 + n_dev), _mesh(n_dev), 2)


def test_all_ops_prove_over_8_shards_matches_reference(host_reference):
    _check_mesh_proof(_all_ops, _mesh(8))


@pytest.mark.parametrize("log_blowup", [1, 2])
def test_gathered_bytes_of_a_prove_equal_the_formula(log_blowup):
    """A prove over 4 row shards gathers onto the lead only the trees'
    columns with fewer rows than shards and the FRI vectors the chain
    takes there; the one-device prove none and the same bytes."""
    cx = _ab_graph(T, 16, 3)
    settings = T.gen_circuit_settings(cx, device="cpu")
    pie = T.gen_trace(cx, settings, device="cpu")
    one = T.prove(pie, settings, _config(T, log_blowup), device="cpu")
    with S.prove_mesh(_mesh(4)):
        S.reset_bytes()
        proof = T.prove(pie, settings, _config(T, log_blowup))
    gathered = S.BYTES["gathered"]
    assert serde.proof_to_flat_bytes(proof) == serde.proof_to_flat_bytes(one)
    lay = AirLayout(proof.claim, settings)
    logs = [lay.pp_logs(), lay.main_logs, lay.inter_logs, [lay.composition_log] * 4]
    assert gathered == S.expected_gathered_bytes(4, logs, log_blowup, proof.config.fri) > 0
    assert S.BYTES["moved"] > 0 and S.BYTES["scattered"] > 0
    S.reset_bytes()
    with S.prove_mesh(_mesh(1)):
        T.prove(pie, settings, _config(T, log_blowup))
    assert S.BYTES == {"moved": 0, "gathered": 0, "scattered": 0}


@pytest.mark.parametrize("shards", [2, 4])
def test_scattered_bytes_count_what_leaves_the_lead(shards):
    """BYTES["scattered"] holds every byte that leaves the lead's columns:
    a commitment's column blocks of a (C, N) tensor on the lead to the
    other column shards, and K5's trace blocks to the other row shards;
    host words and row blocks scatter nothing."""
    rng = np.random.default_rng(shards)
    mesh, log, n_cols = _mesh(shards), 6, 5
    words = _words(rng, n_cols, 1 << log)
    on_lead = n_cols - S.split_evenly(n_cols, shards)[0][1]
    S.reset_bytes()
    S.ShardedCommit(mesh, {log: f.u32_to_tensor(words)}, 1)
    assert S.BYTES["scattered"] == 4 * on_lead << log
    S.reset_bytes()
    S.ShardedCommit(mesh, {log: words}, 1)
    S.ShardedCommit(mesh, {log: S.stack([_split(mesh, f.u32_to_tensor(w)) for w in words])}, 1)
    assert S.BYTES["scattered"] == 0 and S.BYTES["moved"] > 0
    comp = ALL_COMPONENTS[0]
    tp = tape.record(comp, witness=True)
    cols = [f.u32_to_tensor(_words(rng, 1 << log)) for _ in list(comp.MAIN) + list(comp.PP_IDS)]
    S.reset_bytes()
    S.air_witness_many(mesh, [(tp, cols[: len(comp.MAIN)], cols[len(comp.MAIN) :])], _port_elems(_elements(rng)))
    assert S.BYTES["scattered"] == 4 * len(cols) * ((1 << log) - ((1 << log) // shards))
