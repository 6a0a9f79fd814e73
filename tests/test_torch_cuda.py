"""The port's CUDA kernels against their plain twins, on the card.

These need a CUDA device and nvcc; elsewhere they skip.  On the card (the
shared conftest imports JAX, which these tests do not need):
    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from luminair_tpu_torch import fields as f
from luminair_tpu_torch import kernels

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _leaves(x):
    """The tensors and other values inside a call's arguments: lists,
    tuples and dicts opened, a K6 block's terms and a term's columns."""
    if isinstance(x, (list, tuple)):
        for y in x:
            yield from _leaves(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from _leaves(y)
    elif isinstance(x, (kernels.DomainBlock, kernels.DomainTerm)):
        yield from _leaves(list(vars(x).values()))
    else:
        yield x


def _rnd(rng, dev, *shape):
    return torch.from_numpy(rng.integers(0, f.P, size=shape).astype(np.int32)).to(dev)


# Logs on both sides of a tile (2^12 rows) and of one group pass (2^20).
@pytest.mark.parametrize("log", [1, 2, 7, 12, 13, 20, 21, 25])
def test_circle_fft(dev, log):
    rng = np.random.default_rng(log)
    big = log > 20
    v = _rnd(rng, dev, 1 if big else 3, 1 << log)
    before = kernels.CIRCLE_FFT.launches
    assert torch.equal(kernels.circle_ifft(v), kernels.circle_ifft_plain(v))
    assert kernels.CIRCLE_FFT.launches - before <= 3
    assert torch.equal(kernels.circle_fft(v), kernels.circle_fft_plain(v))
    if log >= 2:
        assert torch.equal(kernels.circle_fft(v, 4), kernels.circle_fft_plain(v, 4))
    for b in (1,) if big else (1, 2, 3, 4):
        before = kernels.CIRCLE_FFT.launches
        assert torch.equal(kernels.circle_lde(v, b), kernels.circle_lde_plain(v, b))
        assert kernels.CIRCLE_FFT.launches - before <= 3


# Bottom logs at t - 1, t, t + 1 and 2t + 1 of the card's tile (t = 10),
# a one-leaf tree, columns at logs inside a tile, and a FRI layer's
# transposed view.
@pytest.mark.parametrize("sig", [
    ((0, 1),), ((9, 3), (4, 2)), ((10, 7), (9, 31), (3, 1)), ((11, 2), (10, 40), (0, 1)),
    ((21, 1), (17, 3), (11, 2)), ("fri", 12),
])
def test_merkle_tree(dev, sig):
    from luminair_tpu_torch.crypto.merkle import MerkleTree

    rng = np.random.default_rng(len(sig) + sum(sig[0]) if sig[0] != "fri" else 99)
    if sig[0] == "fri":
        cols = {sig[1]: _rnd(rng, dev, 1 << sig[1], 4).t()}
    else:
        cols = {log: _rnd(rng, dev, k, 1 << log) for log, k in sig}
    before = kernels.MERKLE.launches
    tree = MerkleTree(cols)
    bottom = max(cols)
    assert kernels.MERKLE.launches - before == -(-(bottom + 1) // (kernels.MERKLE_TILE_LOG + 1))
    plain = kernels.TreeDesc(kernels.tree_layers(bottom, dev), cols)
    kernels.merkle_tree_plain(plain)
    for log in range(bottom + 1):
        assert torch.equal(tree.layers[log], plain.layers[log]), log


# K3's one-fold layer, the largest input's circle fold, at logs below and
# above a CTA's rows (256).
@pytest.mark.parametrize("log", [1, 6, 12, 19])
def test_fri_layer_circle_fold(dev, log):
    from luminair_tpu_torch import circle

    rng = np.random.default_rng(log)
    v, alpha0 = _rnd(rng, dev, 1 << log, 4), _rnd(rng, dev, 4)
    tw = [circle.twiddle_stage(log, 0, True, dev)]
    before = kernels.FRI_LAYER.launches
    assert torch.equal(kernels.fri_layer(v, tw, alpha0), kernels.fri_layer_plain(v, tw, alpha0))
    assert kernels.FRI_LAYER.launches - before == 1


def _quotient_groups(rng, dev, spec):
    """K4's groups from sample points on the circle (z, z - G, z + G of each
    log) or through a domain row ("zero"), as a prove derives them."""
    from luminair_tpu_torch import circle
    from luminair_tpu_torch.pcs import quotients

    z = circle.point_from_t_qm31(torch.from_numpy(rng.integers(0, f.P, 4)))
    samples, evals, points = [], {}, {}
    for log, n_cols, kind in spec:
        if (kind, log) not in points:
            if kind == "zero":
                x, y = (t.to(torch.int64)[5].item() for t in circle.domain_table(log, torch.device("cpu")))
                points[(kind, log)] = tuple(torch.tensor([c, 0] + list(rng.integers(1, f.P, 2))) for c in (x, y))
            else:
                g = circle.point_to_qm31(circle.group_gen(log))
                points[(kind, log)] = {"z": z, "z-": circle.point_sub_qm31(z, g), "z+": circle.point_add_qm31(z, g)}[kind]
        for _ in range(n_cols):
            key = (0, len(evals))
            evals[key] = _rnd(rng, dev, 1 << log)
            samples.append(quotients.ColumnSample(log, *key, points[(kind, log)], rng.integers(0, f.P, 4).astype(np.uint32)))
    return quotients.quotient_groups(samples, evals, torch.from_numpy(rng.integers(0, f.P, 4)))


# Several logs in one call, S of 1 to 300, three points at one log, a line
# through a domain row, logs below a CTA's 512 rows.
@pytest.mark.parametrize("spec", [
    [(3, 1, "z"), (10, 7, "z"), (10, 2, "z-"), (12, 56, "z"), (9, 300, "z")],
    [(11, 5, "z"), (11, 2, "z-"), (11, 3, "z+"), (0, 2, "z"), (1, 1, "z-")],
    [(10, 6, "zero"), (10, 3, "z"), (13, 4, "z")],
])
def test_deep_quotient(dev, spec):
    rng = np.random.default_rng(len(spec) + spec[0][0])
    plan = kernels.QuotientPlan(_quotient_groups(rng, dev, spec))
    before = kernels.DEEP_QUOTIENT.launches
    got = kernels.deep_quotient_many(plan)
    assert kernels.DEEP_QUOTIENT.launches - before == 1
    want = kernels.deep_quotient_many_plain(plan)
    assert list(got) == list(want)
    for log in want:
        assert torch.equal(got[log], want[log]), log


# K3: one to four folds of a layer in one launch, inputs joining at every
# fold position, taken up at a later fold of its challenge.
@pytest.mark.parametrize("folds,joins", [(1, (0,)), (2, (0, 1)), (3, (2,)), (3, (0, 2)), (4, (0, 1, 2, 3)), (4, ())])
@pytest.mark.parametrize("t0", [0, 2])
def test_fri_layer(dev, folds, joins, t0):
    from luminair_tpu_torch import circle

    rng = np.random.default_rng(50 + 10 * folds + t0 + len(joins))
    kmax, L = 15, 14
    v = _rnd(rng, dev, 1 << L, 4)
    tws = [circle.twiddle_stage(kmax, kmax - (L - t), True, dev) for t in range(folds)]
    mixes = [(_rnd(rng, dev, 1 << (L - t), 4), circle.twiddle_stage(L - t, 0, True, dev)) if t in joins else None
             for t in range(folds)]
    args = (v, tws, _rnd(rng, dev, 4), t0, mixes, _rnd(rng, dev, 4))
    before = kernels.FRI_LAYER.launches
    assert torch.equal(kernels.fri_layer(*args), kernels.fri_layer_plain(*args))
    assert kernels.FRI_LAYER.launches - before == 1


# The commit chain at the FRI inputs of the three chip_smoke.py paths
# (bench_n256, pinn_b256 and its 80-bit profile): K3 launches once for the
# largest input's circle fold and once a committed layer (8 / 10 / 10), and
# the chain equals the chain with every K3 call through the twin.
@pytest.mark.parametrize("logs,high_security,launches", [
    ((19, 18, 17), False, 8), ((23, 22, 18, 16, 14), False, 10), ((23, 22, 18, 16, 14), True, 10),
])
def test_fri_commit_chain_launches(dev, monkeypatch, logs, high_security, launches):
    from luminair_tpu_torch.pcs import fri
    from luminair_tpu_torch.pcs.config import PcsConfig

    cfg = (PcsConfig.high_security() if high_security else PcsConfig()).fri
    rng = np.random.default_rng(len(logs) + high_security)
    inputs = {k: _rnd(rng, dev, 1 << k, 4) for k in logs}
    args = (inputs, cfg.log_blowup_factor + cfg.log_last_layer_degree_bound, cfg.folds_per_layer, bytes(range(32)), 0)
    kernels.reset_counts()
    got = fri.commit_chain(*args)
    assert kernels.FRI_LAYER.launches == launches
    monkeypatch.setattr(kernels, "fri_layer", kernels.fri_layer_plain)
    want = fri.commit_chain(*args)
    assert got[:2] == want[:2]
    for a, b in zip(got[2] + got[3] + [got[4]], want[2] + want[3] + [want[4]]):
        assert np.array_equal(a, b)
    assert torch.equal(got[5], want[5])
    for (log_a, evals_a, _), (log_b, evals_b, _) in zip(got[6], want[6]):
        assert log_a == log_b and torch.equal(evals_a, evals_b)


# ---------------------------------------------------------------------------
# K8: the channel; K9: the decommitment pass; K10: the proof-of-work search.


def _channel_state(rng, dev, counter):
    s = _rnd(rng, dev, kernels.CHANNEL_WORDS)
    s[8] = counter
    return s


# alpha0's draw (K8's one launch), and K8's step in the root pass of FRI
# layers' trees of one pass (logs 0, 10), two (11, 14) and three (22).
@pytest.mark.parametrize("counter", [0, 1, 7, 1000])
def test_channel_kernels(dev, counter):
    rng = np.random.default_rng(counter)
    for log in (0, 10, 11, 14, 22):
        state = _channel_state(rng, dev, counter)
        a, b = state.clone(), state.clone()
        out_a, out_b = torch.zeros(4, dtype=torch.int32, device=dev), torch.zeros(4, dtype=torch.int32, device=dev)
        assert torch.equal(kernels.channel_draw_felt(a, out_a), kernels.channel_draw_felt_plain(b, out_b))
        assert torch.equal(out_a, out_b) and torch.equal(out_a, a[9:])
        cols = {log: _rnd(rng, dev, 1 << log, 4).t()}
        a, b = state.clone(), state.clone()
        out_a, out_b = torch.zeros(12, dtype=torch.int32, device=dev), torch.zeros(12, dtype=torch.int32, device=dev)
        launches, hosted = kernels.CHANNEL.launches, kernels.CHANNEL.hosted
        tree = kernels.TreeDesc(kernels.tree_layers(log, dev), cols)
        kernels.merkle_tree(tree, a, out_a)
        assert kernels.CHANNEL.launches == launches and kernels.CHANNEL.hosted == hosted + 1
        plain = kernels.TreeDesc(kernels.tree_layers(log, dev), cols)
        kernels.merkle_tree_plain(plain)
        kernels.channel_mix_root_draw_plain(b, plain.layers[0][0], out_b)
        assert all(torch.equal(tree.layers[l], plain.layers[l]) for l in range(log + 1))
        assert torch.equal(a, b) and torch.equal(out_a, out_b)


def _grind(dev, digest: bytes, bits: int) -> int:
    """One K10 call, one launch; the least passing nonce (the twin's and,
    at 12 bits and below, the host channel's)."""
    from luminair_tpu_torch.crypto.channel import Blake2sChannel

    before = kernels.GRIND_POW.launches
    nonce = kernels.grind_pow(digest, bits, dev)
    assert kernels.GRIND_POW.launches == before + 1
    assert nonce == kernels.grind_pow_plain(digest, bits, dev)
    ch = Blake2sChannel()
    ch.digest = digest
    assert ch.check_pow_nonce(bits, nonce)
    if bits <= 12:
        assert nonce == ch.grind_pow(bits)
    return nonce


@pytest.mark.parametrize("bits", [0, 1, 5, 9, 12, 16, 20])
def test_grind_pow(dev, bits):
    _grind(dev, np.random.default_rng(bits).integers(0, 1 << 32, 8, dtype=np.uint64).astype("<u4").tobytes(), bits)


def test_grind_pow_beyond_the_first_round(dev):
    """16-bit searches whose first passing nonce lies beyond the first round
    of W = pow_ctas(16, SMs) x POW_THREADS nonces: the first such digest of
    seeds 0, 1, ... and of seeds 100, 101, ...."""
    W = kernels.pow_ctas(16, torch.cuda.get_device_properties(dev).multi_processor_count) * kernels.POW_THREADS
    for first in (0, 100):
        for seed in range(first, first + 50):
            digest = np.random.default_rng(seed).integers(0, 1 << 32, 8, dtype=np.uint64).astype("<u4").tobytes()
            if _grind(dev, digest, 16) >= W:
                break
        else:
            raise AssertionError("no 16-bit nonce beyond the first round in 50 seeds")


def test_decommit(dev):
    """Trees of an opening pass at sizes on both sides of a slice (16K
    output words), a FRI layer's transposed view among them."""
    from luminair_tpu_torch.crypto.merkle import MerkleTree

    rng = np.random.default_rng(3)
    trees = [
        MerkleTree({12: _rnd(rng, dev, 7, 1 << 12), 10: _rnd(rng, dev, 40, 1 << 10), 4: _rnd(rng, dev, 2, 16)}),
        MerkleTree({10: _rnd(rng, dev, 1 << 10, 4).t()}),
        MerkleTree({3: _rnd(rng, dev, 1, 8)}),
    ]
    queries = [
        {12: np.unique(rng.integers(0, 1 << 12, 200)), 10: np.unique(rng.integers(0, 1 << 10, 64)),
         4: np.array([0, 15])},
        {10: np.array([0, 1, 5, 1023])},
        {},
    ]
    plan = kernels.DecommitPass([t.desc for t in trees], queries)
    assert plan.slices > 1
    assert torch.equal(kernels.decommit(plan), kernels.decommit_plain(plan))
    # Above shared memory: every position of a tree with columns at 2^14
    # and 2^13 merges 32,768 positions, held in device memory.
    big = MerkleTree({14: _rnd(rng, dev, 3, 1 << 14), 13: _rnd(rng, dev, 2, 1 << 13)})
    plan = kernels.DecommitPass([big.desc, trees[0].desc], [{14: np.arange(1 << 14), 13: np.arange(1 << 13)},
                                                            queries[0]])
    assert not plan.in_shared
    assert torch.equal(kernels.decommit(plan), kernels.decommit_plain(plan))


# ---------------------------------------------------------------------------
# K5 / K6: every component's tape; K7: OODS values.

from luminair_tpu_torch.air import tape  # noqa: E402
from luminair_tpu_torch.air.components import ALL_COMPONENTS  # noqa: E402

COMPONENT_NAMES = [c.name for c in ALL_COMPONENTS]


def _words(rng, n):
    return [tuple(int(x) for x in rng.integers(0, f.P, 4)) for _ in range(n)]


def _ew(rng):
    return [[q for q in _words(rng, 2)] for _ in tape.ELEM_KINDS]


@pytest.mark.parametrize("log", [6, 12])
@pytest.mark.parametrize("name", COMPONENT_NAMES)
def test_air_witness(dev, name, log):
    comp = ALL_COMPONENTS[COMPONENT_NAMES.index(name)]
    tp = tape.record(comp, witness=True)
    rng = np.random.default_rng(COMPONENT_NAMES.index(name) + log)
    main = [_rnd(rng, dev, 1 << log) for _ in comp.MAIN]
    pp = [_rnd(rng, dev, 1 << log) for _ in comp.PP_IDS]
    ew = _ew(rng)
    out, claimed = kernels.air_witness(tp, main, pp, ew)
    ref_out, ref_claimed = tape.witness_plain(tp, main, pp, ew)
    assert torch.equal(out, ref_out)
    assert torch.equal(claimed, ref_claimed)


@pytest.mark.parametrize("log_blowup", [1, 2])
@pytest.mark.parametrize("name", COMPONENT_NAMES)
def test_air_domain(dev, name, log_blowup):
    comp = ALL_COMPONENTS[COMPONENT_NAMES.index(name)]
    tp = tape.record(comp)
    log_trace = 6
    m = 1 << (log_trace + log_blowup)
    rng = np.random.default_rng(100 + COMPONENT_NAMES.index(name) + log_blowup)
    main = [_rnd(rng, dev, m) for _ in comp.MAIN]
    pp = [_rnd(rng, dev, m) for _ in comp.PP_IDS]
    inter = [_rnd(rng, dev, m) for _ in range(4 * tp.n_relations)]
    is_first = _rnd(rng, dev, m)
    claimed, alpha, start = _words(rng, 3)
    ew = _ew(rng)
    pows, _ = f.qm31_powers_ints(start, alpha, tp.n_pows)
    args = (tp, main, pp, inter, is_first, claimed, ew, pows, log_trace, 1 << log_blowup)
    assert torch.equal(kernels.air_domain(*args), tape.domain_plain(*args))


# Random words (every constraint fails nearly everywhere) and zeros (every
# recorded constraint vanishes, the LogUp ones where their multiplicity is 0).
@pytest.mark.parametrize("fill", ["random", "zeros"])
@pytest.mark.parametrize("log", [1, 6, 12])
@pytest.mark.parametrize("name", COMPONENT_NAMES)
def test_air_check(dev, name, log, fill):
    comp = ALL_COMPONENTS[COMPONENT_NAMES.index(name)]
    tp = tape.record(comp)
    n = 1 << log
    rng = np.random.default_rng(200 + COMPONENT_NAMES.index(name) + log)

    def col():
        return _rnd(rng, dev, n) if fill == "random" else torch.zeros(n, dtype=f.I32, device=dev)

    main, pp = [col() for _ in comp.MAIN], [col() for _ in comp.PP_IDS]
    inter = [col() for _ in range(4 * tp.n_relations)]
    is_first = torch.zeros(n, dtype=f.I32, device=dev)
    is_first[0] = 1
    (claimed,) = _words(rng, 1)
    args = (tp, main, pp, inter, is_first, claimed, _ew(rng))
    before = kernels.AIR_CHECK.launches
    got = kernels.air_check(*args)
    assert kernels.AIR_CHECK.launches - before == 1
    assert got.is_cuda and torch.equal(got, tape.check_plain(*args))


# Groups below, at and above a chunk (2^11 rows), more than 256 columns,
# one row; all of a call in one launch of the wrapper.
@pytest.mark.parametrize("groups", [((0, 3), (1, 2), (5, 7)), ((11, 3), (13, 20), (6, 300)), ((22, 4), (21, 64))])
def test_oods_eval_many(dev, groups):
    from luminair_tpu_torch import circle, fft

    rng = np.random.default_rng(sum(log * 1000 + C for log, C in groups))
    args = []
    for log, C in groups:
        t = torch.from_numpy(rng.integers(0, f.P, 4))
        args.append(([_rnd(rng, dev, 1 << log) for _ in range(C)], fft.twiddle_chain(log, circle.point_from_t_qm31(t))))
    before = kernels.OODS_EVAL.launches
    got = kernels.oods_eval_many(args)
    assert kernels.OODS_EVAL.launches - before == 1
    assert torch.equal(got, kernels.oods_eval_many_plain(args))


def test_prove_path_never_takes_a_plain_twin(dev, monkeypatch):
    """Every `*_plain` twin raises when a CUDA tensor reaches it; a prove on
    the card then runs through the kernels alone, and each one launches."""
    from luminair_tpu_torch import prelude as T
    from luminair_tpu_torch.crypto import blake2s

    def guard(mod, name):
        fn = getattr(mod, name)

        def checked(*args, **kwargs):
            flat = list(_leaves([args, kwargs]))
            if any(isinstance(a, torch.Tensor) and a.is_cuda or isinstance(a, (kernels.DecommitPass, kernels.QuotientPlan))
                   and a.dev.type == "cuda" or isinstance(a, torch.device) and a.type == "cuda" for a in flat):
                raise AssertionError(f"{name} reached with a CUDA tensor")
            return fn(*args, **kwargs)

        monkeypatch.setattr(mod, name, checked)

    for mod in (kernels, tape, blake2s):
        for name in [n for n in dir(mod) if n.endswith("_plain")]:
            guard(mod, name)
    cx = T.Graph()
    rng = np.random.default_rng(0)
    a = cx.tensor((8, 8)).set(rng.normal(size=(8, 8)))
    b = cx.tensor((8, 8)).set(rng.normal(size=(8, 8)))
    (a * b + a).retrieve()
    cx.compile()
    from luminair_tpu_torch.graph.trace import gen_circuit_settings_host, gen_trace_host

    settings = gen_circuit_settings_host(cx)
    pie = gen_trace_host(cx, settings)  # host words: the prover uploads them
    bottoms = []
    tree = kernels.merkle_tree

    def counted_tree(desc, *channel):
        bottoms.append(desc.bottom)
        return tree(desc, *channel)

    monkeypatch.setattr(kernels, "merkle_tree", counted_tree)
    kernels.reset_counts()
    proof = T.prove(pie, settings, device=dev)
    prove_kernels = kernels.KERNELS[:10]  # K1-K10; the trace ran on the host
    assert all(k.launches > 0 for k in prove_kernels), kernels.counts()
    _check_fri_launches(proof)
    # K2: ceil((L + 1) / (t + 1)) launches per tree; K7: one call per prove.
    assert kernels.MERKLE.launches == sum(-(-(b + 1) // (kernels.MERKLE_TILE_LOG + 1)) for b in bottoms)
    assert len(bottoms) == 4 + len(proof.pcs_proof.fri_proof.layer_roots)
    assert kernels.OODS_EVAL.launches == 1
    assert kernels.DEEP_QUOTIENT.launches == 1
    assert kernels.AIR_WITNESS.launches == 1 and kernels.AIR_DOMAIN.launches == 1


def test_verify_on_the_card_recommits_through_the_kernels(dev, monkeypatch):
    """A verify of an N=16 proof on the card: the preprocessed recommit
    launches K1 and K2 and its root is the proof's; no `*_plain` twin is
    called at all (the query-side checks are host code of the verifier)."""
    from luminair_tpu_torch import prelude as T
    from luminair_tpu_torch import verifier
    from luminair_tpu_torch.crypto import blake2s

    cx = T.Graph()
    rng = np.random.default_rng(0)
    a = cx.tensor((16, 16)).set(rng.normal(size=(16, 16)))
    b = cx.tensor((16, 16)).set(rng.normal(size=(16, 16)))
    (a * b + a).retrieve()
    cx.compile()
    settings = T.gen_circuit_settings(cx, device=dev)
    proof = T.prove(T.gen_trace(cx, settings, device=dev), settings, device=dev)

    def refuse(name):
        def twin(*args, **kwargs):
            raise AssertionError(f"the verify called {name}")

        return twin

    for mod in (kernels, tape, blake2s):
        for name in [n for n in dir(mod) if n.endswith("_plain")]:
            monkeypatch.setattr(mod, name, refuse(name))
    verifier._PP_ROOT_CACHE.clear()
    kernels.reset_counts()
    assert T.verify(proof, settings) is True
    counts = kernels.counts()
    assert counts["circle_fft"] > 0 and counts["blake2s_merkle"] > 0, counts
    assert {k for k, v in counts.items() if v} == {"circle_fft", "blake2s_merkle"}, counts
    assert [np.asarray(r).tolist() for r in verifier._PP_ROOT_CACHE.values()] == [proof.roots[0].tolist()]


def _check_fri_launches(proof):
    """K8 launched once, for alpha0, and its step run once per committed
    FRI layer in the layer's root pass; K3 once for the largest input's
    circle fold and once per layer, K9 once (one opening pass for the FRI
    layers and the trees), K10 once."""
    n_layers = len(proof.pcs_proof.fri_proof.layer_roots)
    assert kernels.CHANNEL.launches == 1 and kernels.CHANNEL.hosted == n_layers and n_layers > 0
    assert kernels.FRI_LAYER.launches == 1 + n_layers  # the circle fold, then one launch a layer
    assert kernels.DECOMMIT.launches == 1
    assert kernels.GRIND_POW.launches == 1


# ---------------------------------------------------------------------------
# The trace kernels (trace_segment, T3, T4), on the six op graphs.

from luminair_tpu_torch.models import op_graphs  # noqa: E402

SEGMENT_RUNS = 3


def _graph(name):
    from luminair_tpu_torch import prelude as T

    cx = T.Graph()
    op_graphs.GRAPHS[name](cx, op_graphs.DATA)
    cx.compile()
    return cx


def _bench_graph(n=16):
    from luminair_tpu_torch import prelude as T

    cx = T.Graph()
    rng = np.random.default_rng(0)
    a = cx.tensor((n, n)).set(rng.normal(size=(n, n)))
    b = cx.tensor((n, n)).set(rng.normal(size=(n, n)))
    (a * b + a).retrieve()
    cx.compile()
    return cx


def _pinn_graph(batch=16):
    from luminair_tpu_torch import prelude as T
    from luminair_tpu_torch.models import black_scholes as BS

    cx = T.Graph()
    x, _ = BS.build(cx, BS.load_weights(), batch=batch)
    rng = np.random.default_rng(7)
    x.set(np.column_stack([rng.uniform(5.0, 30.0, batch), rng.uniform(0.05, 1.0, batch)]))
    cx.compile()
    return cx


def _recorded_trace(cx, dev, monkeypatch):
    """The card's settings pass and trace of `cx`, every segment and T3
    step they launched kept."""
    from luminair_tpu_torch import prelude as T

    calls = []
    for wrapper in ("trace_segment", "trace_reduce"):
        fn = getattr(kernels, wrapper)

        def rec(x, fn=fn, wrapper=wrapper):
            calls.append((wrapper, x))
            return fn(x)

        monkeypatch.setattr(kernels, wrapper, rec)
    T.gen_trace(cx, T.gen_circuit_settings(cx, device=dev), device=dev)
    monkeypatch.undo()
    assert any(w == "trace_segment" for w, _ in calls)
    return calls


def _check_trace_calls(calls):
    """Each segment through its kernel SEGMENT_RUNS times from fresh outputs
    against its twin, and each T3 step once."""
    for wrapper, x in calls:
        if wrapper == "trace_reduce":
            k, p = x.fresh(), x.fresh()
            kernels.trace_reduce(k)
            kernels.trace_reduce_plain(p)
            assert torch.equal(k.outputs(), p.outputs()), x.op
            continue
        want = x.fresh()
        kernels.trace_segment_plain(want)
        for run in range(SEGMENT_RUNS):
            got = x.fresh()
            kernels.trace_segment(got)
            assert torch.equal(got.outputs(), want.outputs()), (run, [it.op for it in x.items()])


@pytest.mark.parametrize("name", list(op_graphs.GRAPHS))
def test_trace_kernels_match_twins(dev, name, monkeypatch):
    """Every segment and T3 step the card's settings pass and trace launch,
    run again through its kernel and through its plain twin on fresh
    outputs (each segment several times); each segment's node items also
    alone, as one-node segments (trace_binary / trace_unary /
    trace_encode)."""
    calls = _recorded_trace(_graph(name), dev, monkeypatch)
    _check_trace_calls(calls)
    for wrapper, x in calls:
        if wrapper != "trace_segment":
            continue
        for step in x.fresh().steps():
            if step.op == "pad":
                continue
            wrapper = ("trace_binary" if step.op in ("add", "mul", "rem", "less_than")
                       else "trace_encode" if step.op == "encode" else "trace_unary")
            k, p = step.fresh(), step.fresh()
            getattr(kernels, wrapper)(k)
            getattr(kernels, wrapper + "_plain")(p)
            assert torch.equal(k.outputs(), p.outputs()), step.op


@pytest.mark.parametrize("name", list(op_graphs.GRAPHS))
def test_card_trace_equals_cpu_trace(dev, name):
    from luminair_tpu_torch import prelude as T

    cx_gpu, cx_cpu = _graph(name), _graph(name)
    s_gpu, s_cpu = T.gen_circuit_settings(cx_gpu, device=dev), T.gen_circuit_settings(cx_cpu, device="cpu")
    assert s_gpu.to_dict() == s_cpu.to_dict()
    p_gpu, p_cpu = T.gen_trace(cx_gpu, s_gpu, device=dev), T.gen_trace(cx_cpu, s_cpu, device="cpu")
    assert list(p_gpu.trace_tables) == list(p_cpu.trace_tables)
    for tname, t in p_cpu.trace_tables.items():
        for col, v in t.padded.items():
            assert p_gpu.trace_tables[tname].padded[col].is_cuda
            assert torch.equal(p_gpu.trace_tables[tname].padded[col].cpu(), v), (tname, col)
    for rid, v in cx_cpu.output_data.items():
        assert np.array_equal(cx_gpu.output_data[rid], v)


# One cell of a card PIE changed (graph, table, column, row), or none.
@pytest.mark.parametrize("cell", [None, ("all_ops", "mul", "out", 3), ("all_ops", "less_than", "diff", 1),
                                  ("negative", "sqrt", "rem", 4), ("reduce_axes", "sum_reduce", "acc", 1)])
def test_check_pie_constraints_from_a_card_pie(dev, cell):
    """check_pie_constraints on a card PIE launches K5 and air_check only and
    gives the CPU's dict for the same PIE (its host form)."""
    from luminair_tpu_torch import prelude as T
    from luminair_tpu_torch.air.debug import check_pie_constraints
    from luminair_tpu_torch.air.pie import LuminairPie, TraceTable

    name = cell[0] if cell else "all_ops"
    cx = _graph(name)
    settings = T.gen_circuit_settings(cx, device=dev)
    pie = T.gen_trace(cx, settings, device=dev)
    if cell:
        column = pie.trace_tables[cell[1]].padded[cell[2]]
        column[cell[3]] = (int(column[cell[3]]) + 1) % f.P
    kernels.reset_counts()
    got = check_pie_constraints(pie, settings)
    assert {k: v for k, v in kernels.counts().items() if v} == {"air_witness": 1, "air_check": 1}, kernels.counts()
    host = LuminairPie({k: TraceTable(k, t.host_columns()) for k, t in pie.trace_tables.items()}, pie.metadata)
    assert got == check_pie_constraints(host, settings, device="cpu")
    assert (got == {}) == (cell is None)


@pytest.mark.parametrize("path", ["bench_n16", "pinn_b16"])
def test_trace_segments_of_paths(dev, path, monkeypatch):
    """The bench graph's and the PINN's segments (and T3 steps) against
    their twins, several runs each; one launch per segment."""
    cx = _bench_graph() if path == "bench_n16" else _pinn_graph()
    kernels.reset_counts()
    calls = _recorded_trace(cx, dev, monkeypatch)
    segments = sum(w == "trace_segment" for w, _ in calls)
    assert kernels.TRACE_SEGMENT.launches == segments
    assert segments <= 2 + kernels.TRACE_REDUCE.launches + kernels.LUT_BOUNDARY.launches
    _check_trace_calls(calls)


@pytest.mark.parametrize("case", ["edges", "normal"])
def test_encode_on_card_matches_twin(dev, case):
    """The encode item on the card (a one-item segment) against its twin on
    the CPU and the host's fixed.from_float, at the encoding's edges
    (tests/float_edges.py) and on a normal(0, 1) draw of 2^12."""
    import importlib.util
    from pathlib import Path

    from luminair_tpu_torch import fixed
    from luminair_tpu_torch.graph.view import View

    spec = importlib.util.spec_from_file_location("float_edges", Path(__file__).with_name("float_edges.py"))
    edges = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(edges)  # by path: the card's runs take no conftest, and `tests` may name another package
    x = edges.edge_floats() if case == "edges" else edges.EDGE_CASES["normal"]
    bits = torch.from_numpy(x.view(np.int64).copy())
    step = kernels.TraceStep("encode", [(bits.to(dev), View.contiguous((len(x),)))], len(x),
                             out=torch.zeros(len(x), dtype=torch.int64, device=dev))
    kernels.trace_encode(step)
    p = kernels.TraceStep("encode", [(bits, View.contiguous((len(x),)))], len(x),
                          out=torch.zeros(len(x), dtype=torch.int64))
    kernels.trace_encode_plain(p)
    with np.errstate(all="ignore"):
        want = fixed.from_float(x)
    assert np.array_equal(p.out.numpy(), want)
    assert np.array_equal(step.out.cpu().numpy(), want)


def test_bench_graph_encodes_on_card(dev):
    """The bench graph a * b + a on the card: trace_segment launches once a
    pass; the settings pass encodes both inputs (the encode items ride in
    its one segment, first, `encoded_inputs` the inputs' lengths), the
    trace pass takes them from the graph's resident encoding and has no
    encode item; the card's settings, PIE and outputs are the CPU's.  A
    second request that sets one input again proves the bytes a freshly
    built graph proves on the card."""
    from luminair_tpu_torch import prelude as T
    from luminair_tpu_torch import serde, tracing
    from luminair_tpu_torch.graph.view import View

    cx = _bench_graph()
    n_inputs = sum(len(v) for v in cx.input_data.values())
    segs = []
    launch = kernels.trace_segment

    def keep(seg):
        segs.append(seg)
        return launch(seg)

    kernels.reset_counts()
    kernels.trace_segment = keep
    try:
        settings = T.gen_circuit_settings(cx, device=dev)
        pie = T.gen_trace(cx, settings, device=dev)
    finally:
        kernels.trace_segment = launch
    assert kernels.counts()["trace_segment"] == 2 == len(segs)
    for seg, encodes in zip(segs, (2, 0)):
        ops = [it.op for it in seg.items()]
        assert ops.count("encode") == encodes and (not encodes or ops.index("encode") == 0), ops
        assert seg.p1 - seg.p0 == 1  # every reader of an input at its own row: no phase added
    spans = tracing.requests()[-1].spans
    for kind, encoded in (("settings", n_inputs), ("trace", 0)):
        (sp,) = [s for s in spans if s.path == kind + "/launches"]
        (up,) = [s for s in spans if s.path == kind + "/upload"]
        assert sp.counts["encoded_inputs"] == encoded
        assert up.counts[tracing.RESIDENT_INPUTS] == n_inputs - encoded
        assert up.counts[tracing.H2D_REPEAT] == 0
    cpu = _bench_graph()
    s_cpu = T.gen_circuit_settings(cpu, device="cpu")
    p_cpu = T.gen_trace(cpu, s_cpu, device="cpu")
    assert settings.to_dict() == s_cpu.to_dict()
    for tname, t in p_cpu.trace_tables.items():
        for col, v in t.padded.items():
            assert torch.equal(pie.trace_tables[tname].padded[col].cpu(), v), (tname, col)
    for rid, v in cpu.output_data.items():
        assert np.array_equal(cx.output_data[rid], v)

    b = T.GraphTensor(cx, max(cx.input_data), View.contiguous((n_inputs // 2,)))
    b.set(np.random.default_rng(1).normal(size=len(cx.input_data[b.node_id])))
    settings = T.gen_circuit_settings(cx, device=dev)
    proof = T.prove(T.gen_trace(cx, settings, device=dev), settings, device=dev)
    fresh = _bench_graph()
    for nid, v in cx.input_data.items():
        T.GraphTensor(fresh, nid, View.contiguous((len(v),))).set(v.copy())
    f_settings = T.gen_circuit_settings(fresh, device=dev)
    f_proof = T.prove(T.gen_trace(fresh, f_settings, device=dev), f_settings, device=dev)
    assert serde.settings_to_flat_bytes(settings) == serde.settings_to_flat_bytes(f_settings)
    assert serde.proof_to_flat_bytes(proof) == serde.proof_to_flat_bytes(f_proof)
    for rid, v in fresh.output_data.items():
        assert np.array_equal(cx.output_data[rid], v), rid


def _random_view(rng):
    from luminair_tpu_torch.graph.view import View

    shape = tuple(int(x) for x in rng.integers(1, 9, rng.integers(1, 5)))
    v = View.contiguous(shape)
    for _ in range(rng.integers(1, 6)):
        kind, d = rng.integers(0, 4), int(rng.integers(0, len(v.sizes)))
        if kind == 0:
            v = v.permute(tuple(int(x) for x in rng.permutation(len(v.sizes))))
        elif kind == 1 and v.sizes[d] > 1:
            start = int(rng.integers(0, v.sizes[d]))
            v = v.slice(d, start, int(rng.integers(start, v.sizes[d] + 1)))
        elif kind == 2 and len(v.sizes) < kernels.VIEW_MAX_DIMS:
            v = v.insert(d, int(rng.integers(1, 4)))
        else:
            v = v.pad(d, int(rng.integers(0, 3)), int(rng.integers(0, 3)))
    return v


@pytest.mark.parametrize("seed", range(4))
def test_packed_views_on_card(dev, seed):
    """Random views resolved by the kernel's 32-bit packed gather (a
    contiguous step, one-node segment) against View.gather on the card."""
    from luminair_tpu_torch.graph.device_trace import TABLE_COLUMNS

    rng = np.random.default_rng(500 + seed)
    for _ in range(25):
        v = _random_view(rng)
        buf = torch.from_numpy(rng.integers(-2**62, 2**62, max(v.buffer_len, 1))).to(dev)
        rows = max(len(buf), v.n_elements)
        step = kernels.TraceStep(
            "contiguous", [(buf, v)], rows, out=torch.zeros(v.n_elements, dtype=torch.int64, device=dev),
            cols={c: torch.zeros(rows, dtype=torch.int32, device=dev) for c in TABLE_COLUMNS["contiguous"]},
            ids=(3, 2, 0), out_mult=4, in_mult=9)
        k, p = step.fresh(), step.fresh()
        kernels.trace_unary(k)
        kernels.trace_unary_plain(p)
        assert torch.equal(k.out, v.gather(buf)), v
        assert torch.equal(k.outputs(), p.outputs()), v


# T3's scan at segments below, at and above a CTA's 256 rows (walked in
# chunks), inputs a stride of `back` apart.
@pytest.mark.parametrize("back", [1, 5, 64])
@pytest.mark.parametrize("dsize", [1, 2, 3, 64, 300, 1025])
@pytest.mark.parametrize("op", ["sum_reduce", "max_reduce"])
def test_trace_reduce_scan(dev, op, dsize, back):
    from luminair_tpu_torch.graph.device_trace import TABLE_COLUMNS
    from luminair_tpu_torch.graph.view import View

    rng = np.random.default_rng(dsize * 100 + back)
    hi = 2**31 if op == "max_reduce" else 2**62
    buf = torch.from_numpy(rng.integers(-hi, hi, 2 * dsize * back)).to(dev)
    rows = 2 * back
    step = kernels.TraceStep(
        op, [(buf, View.contiguous((2, back, dsize)).permute((0, 2, 1)))], rows,
        out=torch.zeros(rows, dtype=torch.int64, device=dev),
        cols={c: torch.zeros(rows * dsize, dtype=torch.int32, device=dev) for c in TABLE_COLUMNS[op]},
        ids=(9, 2, 0), out_mult=3, dsize=dsize, back=back, mult=torch.zeros(256, dtype=torch.int32, device=dev),
        flag=torch.zeros(1, dtype=torch.int32, device=dev))
    k, p = step.fresh(), step.fresh()
    kernels.trace_reduce(k)
    kernels.trace_reduce_plain(p)
    assert torch.equal(k.outputs(), p.outputs())


# T4: one CTA up to 16,384 source values, a last-CTA pass above; sources
# 16-byte aligned or not; one staging region over several launches (its
# counter goes back to 0).
@pytest.mark.parametrize("n", [1, 5, 1024, 16384, 16385, 100_003, 5_000_001])
@pytest.mark.parametrize("offset", [0, 1])
def test_lut_boundary(dev, n, offset):
    rng = np.random.default_rng(n + offset)
    buf = torch.from_numpy(rng.integers(-2**62, 2**62, n + offset)).to(dev)
    src = buf[offset:]
    staging = torch.zeros(kernels.lut_boundary_words(n, 4096), dtype=torch.int64, device=dev)
    for gn in (4096, 0, 17):
        gathered = torch.from_numpy(rng.integers(-2**62, 2**62, gn)).to(dev)
        before = kernels.LUT_BOUNDARY.launches
        assert torch.equal(kernels.lut_boundary(src, gathered, staging), kernels.lut_boundary_plain(src, gathered))
        assert kernels.LUT_BOUNDARY.launches - before == 1
        if kernels.lut_boundary_words(n, 0) > 2:
            assert int(staging[-1]) == 0


def test_prove_from_card_trace_never_touches_the_host(dev, monkeypatch):
    """The bench graph's settings, trace and prove on the card with every
    plain twin guarded against CUDA tensors and the host upload of trace
    columns guarded: each of the thirteen kernels launches, and the proof
    equals the CPU's."""
    from luminair_tpu_torch import prelude as T
    from luminair_tpu_torch import serde
    from luminair_tpu_torch.crypto import blake2s

    def is_cuda(x):
        if isinstance(x, kernels.TraceStep):
            return x.srcs[0][0].is_cuda
        if isinstance(x, kernels.TraceSegment):
            return x.table.buffers.arena.is_cuda
        if isinstance(x, (kernels.DecommitPass, kernels.QuotientPlan)):
            return x.dev.type == "cuda"
        if isinstance(x, torch.device):
            return x.type == "cuda"
        return isinstance(x, torch.Tensor) and x.is_cuda

    def guard(mod, name):
        fn = getattr(mod, name)

        def checked(*args, **kwargs):
            flat = list(_leaves([args, kwargs]))
            if any(is_cuda(a) for a in flat):
                raise AssertionError(f"{name} reached with a CUDA tensor")
            return fn(*args, **kwargs)

        monkeypatch.setattr(mod, name, checked)

    for mod in (kernels, tape, blake2s):
        for name in [n for n in dir(mod) if n.endswith("_plain")]:
            guard(mod, name)
    upload = f.u32_to_tensor

    def no_trace_upload(a, device="cpu", dtype=f.I32):
        if isinstance(a, torch.Tensor):
            raise AssertionError("a trace column went through the host")
        return upload(a, device, dtype)

    monkeypatch.setattr(f, "u32_to_tensor", no_trace_upload)
    cx = _graph("all_ops")
    kernels.reset_counts()
    settings = T.gen_circuit_settings(cx)
    pie = T.gen_trace(cx, settings)
    assert all(c.is_cuda for t in pie.trace_tables.values() for c in t.padded.values())
    proof = T.prove(pie, settings, device=dev)
    assert all(v > 0 for k, v in kernels.counts().items() if k not in ("air_check", "logup_sum", "add_carry")), \
        kernels.counts()
    _check_fri_launches(proof)
    monkeypatch.undo()
    cpu_cx = _graph("all_ops")
    cpu_settings = T.gen_circuit_settings(cpu_cx, device="cpu")
    cpu_proof = T.prove(T.gen_trace(cpu_cx, cpu_settings, device="cpu"), cpu_settings, device="cpu")
    assert serde.proof_to_flat_bytes(proof) == serde.proof_to_flat_bytes(cpu_proof)


@pytest.mark.parametrize("high_security", [False, True])
def test_fri_commit_downloads_once_and_each_pass_uploads_once(dev, monkeypatch, high_security):
    """On the card, the FRI commit chain makes one device-to-host download
    (no root comes down per layer), the proof-of-work search no upload (its
    digest is a launch parameter), and the prove's one decommitment pass
    one upload of its records and positions, and no upload per index."""
    from luminair_tpu_torch import prelude as T
    from luminair_tpu_torch.pcs import fri

    events = []
    for name in ("tensor_to_u32", "upload", "u32_to_tensor"):
        fn = getattr(f, name)

        def counted(*args, fn=fn, name=name, **kw):
            if name != "tensor_to_u32" or args[0].is_cuda:
                events.append(name)
            return fn(*args, **kw)

        monkeypatch.setattr(f, name, counted)
    for mod, name in ((fri, "fri_prove"), (kernels, "decommit"), (kernels, "grind_pow")):
        fn = getattr(mod, name)

        def marked(*args, fn=fn, name=name, **kw):
            events.append(("begin", name))
            out = fn(*args, **kw)
            events.append(("end", name))
            return out

        monkeypatch.setattr(mod, name, marked)
    cx = _graph("all_ops")
    settings = T.gen_circuit_settings(cx)
    pie = T.gen_trace(cx, settings)
    events.clear()
    T.prove(pie, settings, T.PcsConfig.high_security() if high_security else None, device=dev)

    def inside(name):
        spans, cur = [], None
        for e in events:
            if e == ("begin", name):
                cur = []
            elif e == ("end", name):
                spans.append(cur)
                cur = None
            elif cur is not None:
                cur.append(e)
        return spans

    (chain,) = inside("fri_prove")
    assert chain.count("tensor_to_u32") == 1, chain
    passes = inside("decommit")
    assert len(passes) == 1 and all(p.count("upload") == 1 and "u32_to_tensor" not in p for p in passes), passes
    assert inside("grind_pow") == [[]]


# --- several devices (parallel/sharding.py) --------------------------------


@pytest.mark.parametrize("k,log", [(1, 0), (2, 5), (3, 10), (8, 13), (2, 21), (32, 9)])
def test_logup_sum(dev, k, log):
    rng = np.random.default_rng(100 * k + log)
    values, mult = _rnd(rng, dev, k, 1 << log), _rnd(rng, dev, 1 << log)
    z, alpha = rng.integers(0, f.P, 4).tolist(), rng.integers(0, f.P, 4).tolist()
    before = kernels.LOGUP_SUM.launches
    got = kernels.logup_sum(values, mult, z, alpha)
    assert kernels.LOGUP_SUM.launches - before == 1
    assert torch.equal(got, kernels.logup_sum_plain(values, mult, z, alpha))
    assert torch.equal(kernels.logup_sum(values, mult, z, alpha), got)  # the scratch's counter was reset
    wide = _rnd(rng, dev, k, 2 << log)[:, : 1 << log]  # rows of another stride
    assert torch.equal(kernels.logup_sum(wide, mult, z, alpha), kernels.logup_sum_plain(wide, mult, z, alpha))
    with pytest.raises(kernels.KernelError):
        kernels.logup_sum(_rnd(rng, dev, kernels.LOGUP_MAX_K + 1, 4), mult[:4], z, alpha)


def test_logup_plan_reused_on_the_card(dev):
    """Two plans of other (z, alpha), called in turns on four row blocks
    (rows of another stride) each, into rows of one result and not: each
    time the twin's sum, one launch a call."""
    rng = np.random.default_rng(31)
    values, mult = _rnd(rng, dev, 2, 1 << 14), _rnd(rng, dev, 1 << 14)
    zs = [rng.integers(0, f.P, 4).tolist() for _ in range(2)]
    alphas = [rng.integers(0, f.P, 4).tolist() for _ in range(2)]
    plans = [kernels.LogupPlan(z, a, 2) for z, a in zip(zs, alphas)]
    out = torch.zeros((4, 4), dtype=torch.int32, device=dev)
    before = kernels.LOGUP_SUM.launches
    for r in range(4):
        rows = slice(r << 12, (r + 1) << 12)
        for plan, z, a in zip(plans, zs, alphas):
            want = kernels.logup_sum_plain(values[:, rows], mult[rows], z, a)
            assert torch.equal(plan(values[:, rows], mult[rows]), want)
            plan(values[:, rows], mult[rows], out[r])
            assert torch.equal(out[r], want)
    assert kernels.LOGUP_SUM.launches - before == 16


@pytest.mark.parametrize("s", [1, 4, 64])
def test_lead_sum_on_the_card(dev, s):
    from luminair_tpu_torch.parallel import sharding as S

    rng = np.random.default_rng(s)
    parts = torch.from_numpy((f.P - 1 - rng.integers(0, 4, (s, 4))).astype(np.int32)).to(dev)
    want = torch.zeros(4, dtype=torch.int64, device=dev)
    for row in parts:
        want = f.add(want, row.to(torch.int64))
    assert torch.equal(S.lead_sum(parts), want.to(torch.int32))


def _virtual(mesh_kind, dev):
    from luminair_tpu_torch.parallel import sharding as S

    if mesh_kind == "rows_cols_2x2":
        return S.make_mesh(4, (2, 2), devices=[dev] * 4)
    return S.make_chip_mesh(int(mesh_kind), devices=[dev] * int(mesh_kind))


@pytest.mark.parametrize("mesh_kind", ["1", "2", "4", "rows_cols_2x2"])
@pytest.mark.parametrize("log_blowup", [1, 2])
def test_prover_step_on_a_virtual_mesh_of_the_card(dev, mesh_kind, log_blowup):
    """n shards on the card: the CPU's result, and the launches the plan
    names (K1, K2, logup_sum) and no others."""
    from luminair_tpu_torch.parallel import sharding as S

    rng = np.random.default_rng(5)
    cols = rng.integers(0, f.P, size=(16, 1 << 9), dtype=np.uint32)
    mult = rng.integers(0, f.P, size=(1 << 9,), dtype=np.uint32)
    z, alpha = rng.integers(1, f.P, 4, dtype=np.uint32), rng.integers(1, f.P, 4, dtype=np.uint32)
    mesh = _virtual(mesh_kind, dev)
    kernels.reset_counts()
    got = S.prover_step(mesh, cols, mult, z, alpha, log_blowup=log_blowup)
    launches = {k: v for k, v in kernels.counts().items() if v}
    assert launches == S.step_launches(mesh, 16, 9, log_blowup)
    want = S.prover_step(S.make_chip_mesh(1, devices=["cpu"]), cols, mult, z, alpha, log_blowup=log_blowup)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_bench_graph_prove_on_a_virtual_mesh_of_the_card(dev):
    """The N=16 bench graph's card PIE proved over 4 shards of the card:
    the bytes of the card's one-device proof and of the CPU's proof; each
    shard launched K1, K2, K7 and K9."""
    from luminair_tpu_torch import prelude as T
    from luminair_tpu_torch import serde
    from luminair_tpu_torch.parallel import sharding as S

    def graph():
        cx = T.Graph()
        rng = np.random.default_rng(0)
        a = cx.tensor((16, 16)).set(rng.normal(size=(16, 16)))
        b = cx.tensor((16, 16)).set(rng.normal(size=(16, 16)))
        (a * b + a).retrieve()
        cx.compile()
        return cx

    cx = graph()
    settings = T.gen_circuit_settings(cx)
    pie = T.gen_trace(cx, settings)
    one = serde.proof_to_flat_bytes(T.prove(pie, settings, device=dev))
    kernels.reset_counts()
    with S.prove_mesh(_virtual("4", dev)):
        mesh_bytes = serde.proof_to_flat_bytes(T.prove(pie, settings))
    assert mesh_bytes == one
    for r in range(4):
        assert all(kernels.SHARD_LAUNCHES[r].get(k) for k in ("circle_fft", "blake2s_merkle", "decommit", "fri_layer",
                                                              "deep_quotient", "air_witness", "air_domain")), r
    assert sum(1 for r in range(4) if kernels.SHARD_LAUNCHES[r].get("oods_eval")) >= 2
    cpu_cx = graph()
    cpu_settings = T.gen_circuit_settings(cpu_cx, device="cpu")
    cpu = T.prove(T.gen_trace(cpu_cx, cpu_settings, device="cpu"), cpu_settings, device="cpu")
    assert mesh_bytes == serde.proof_to_flat_bytes(cpu)


def _split(mesh, t, dim=-1):
    from luminair_tpu_torch.parallel import sharding as S

    return S.RowBlocks(mesh, [b.contiguous() for b in t.chunk(mesh.size, dim)], dim)


@pytest.mark.parametrize("name", ["mul", "sum_reduce", "max_reduce"])
def test_air_witness_with_a_carry_on_a_virtual_mesh(dev, name):
    """K5 on each of 4 row shards of the card, the totals' exchange and the
    carry pass: the twin's whole interaction and claimed sum; one block
    with a given carry against the twin with it."""
    from luminair_tpu_torch.air import tape
    from luminair_tpu_torch.air.components import COMPONENTS_BY_NAME
    from luminair_tpu_torch.parallel import sharding as S

    comp = COMPONENTS_BY_NAME[name]
    tp = tape.record(comp, witness=True)
    rng = np.random.default_rng(7)
    n = 1 << 12
    main, pp = [_rnd(rng, dev, n) for _ in comp.MAIN], [_rnd(rng, dev, n) for _ in comp.PP_IDS]
    ew = [[tuple(int(w) for w in rng.integers(0, f.P, 4)) for _ in range(2)] for _ in kernels.ELEM_KINDS]
    want, want_claimed = tape.witness_plain(tp, main, pp, ew)
    kernels.reset_counts()
    got, claimed = S.air_witness_many(_virtual("4", dev), [(tp, main, pp)], ew)[0]
    assert all(kernels.SHARD_LAUNCHES[r] == ({"air_witness": 1} if r == 0 else {"air_witness": 1, "add_carry": 1})
               for r in range(4)), kernels.SHARD_LAUNCHES
    assert torch.equal(S.on_lead(got), want) and torch.equal(claimed, want_claimed)
    carry, part = _rnd(rng, dev, 4), slice(n // 2, n)
    out, total = kernels.air_witness(tp, [c[part] for c in main], [c[part] for c in pp], ew, carry)
    plain, plain_total = tape.witness_plain(tp, [c[part] for c in main], [c[part] for c in pp], ew, carry)
    assert torch.equal(out, plain) and torch.equal(total, plain_total)


@pytest.mark.parametrize("log_blowup", [1, 2])
@pytest.mark.parametrize("name", ["mul", "sum_reduce", "max_reduce"])
def test_air_domain_with_halos_on_a_virtual_mesh(dev, name, log_blowup):
    """K6 on each of 4 row shards of the card, each block's halo from its
    neighbours (wrapping at the domain's ends), after the same domain whole
    on the lead in the same call: the twin's quotients on the whole domain
    in both, one launch a shard."""
    from luminair_tpu_torch.air import tape
    from luminair_tpu_torch.air.components import COMPONENTS_BY_NAME
    from luminair_tpu_torch.parallel import sharding as S

    comp = COMPONENTS_BY_NAME[name]
    tp = tape.record(comp)
    rng = np.random.default_rng(11 + log_blowup)
    log = 11
    m = 1 << (log + log_blowup)
    main, pp = [_rnd(rng, dev, m) for _ in comp.MAIN], [_rnd(rng, dev, m) for _ in comp.PP_IDS]
    inter, is_first = [_rnd(rng, dev, m) for _ in range(4 * tp.n_relations)], _rnd(rng, dev, m)
    claimed = tuple(int(w) for w in rng.integers(0, f.P, 4))
    ew = [[tuple(int(w) for w in rng.integers(0, f.P, 4)) for _ in range(2)] for _ in kernels.ELEM_KINDS]
    pows = [tuple(int(w) for w in rng.integers(0, f.P, 4)) for _ in range(tp.n_pows)]
    want = tape.domain_plain(tp, main, pp, inter, is_first, claimed, ew, pows, log, 1 << log_blowup)
    mesh = _virtual("4", dev)
    whole = ([(tp, main, pp, inter, is_first, claimed, pows)], log, 1 << log_blowup)
    rows = ([(tp, [_split(mesh, c) for c in main], [_split(mesh, c) for c in pp], [_split(mesh, c) for c in inter],
              _split(mesh, is_first), claimed, pows)], log, 1 << log_blowup)
    kernels.reset_counts()
    lead, got = S.air_domain_many(mesh, [whole, rows], ew)
    assert all(kernels.SHARD_LAUNCHES[r] == {"air_domain": 1} for r in range(4))
    assert torch.equal(lead, want) and torch.equal(S.on_lead(got), want)


def test_quotient_plans_on_row_blocks_of_the_card(dev):
    """One K4 call a row shard, its domain tables from the block's first
    row: the twin's quotients of the whole domain, block by block."""
    from luminair_tpu_torch import circle
    from luminair_tpu_torch.pcs import quotients as q

    rng = np.random.default_rng(3)
    pt = circle.point_from_t_qm31(torch.from_numpy(rng.integers(0, f.P, 4)))
    samples, evals = [], {}
    for i, log in enumerate([14, 12, 14, 13, 12]):
        evals[(0, i)] = _rnd(rng, dev, 1 << log)
        samples.append(q.ColumnSample(log, 0, i, pt, rng.integers(0, f.P, 4).astype(np.uint32)))
    groups = q.quotient_groups(samples, evals, torch.from_numpy(rng.integers(0, f.P, 4)))
    want = kernels.deep_quotient_many_plain(kernels.QuotientPlan(groups))
    for shards in (2, 4, 8):
        s = shards.bit_length() - 1
        parts = [kernels.deep_quotient_many(kernels.QuotientPlan(
            [(log, [c.chunk(shards)[r].contiguous() for c in cols], g, k) for log, cols, g, k in groups],
            shard=(r, s))) for r in range(shards)]
        for log, w in want.items():
            assert torch.equal(torch.cat([p[log] for p in parts]), w), (shards, log)


@pytest.mark.parametrize("folds", [1, 2, 3])
def test_fri_chain_on_mirror_assembled_blocks(dev, folds):
    """The commit chain with its inputs on 4 row shards of the card (K3 on
    each shard's blocks assembled in nested mirror order, the layers'
    trees sharded) equals the one-device chain on the card; K3 launches on
    every shard."""
    from luminair_tpu_torch import fft
    from luminair_tpu_torch.parallel import sharding as S
    from luminair_tpu_torch.pcs import fri

    rng = np.random.default_rng(folds)
    inputs = {}
    for log in (16, 15, 13, 12):
        coeffs = torch.zeros((4, 1 << log), dtype=torch.int32, device=dev)
        coeffs[:, ::2] = _rnd(rng, dev, 4, 1 << (log - 1))
        inputs[log] = fft.fft(coeffs).t().contiguous()
    digest = rng.integers(0, f.P, 8).astype("<u4").tobytes()
    one = fri.commit_chain(inputs, 3, folds, digest, 3)
    mesh = _virtual("4", dev)
    kernels.reset_counts()
    got = fri.commit_chain({k: _split(mesh, v, 0) for k, v in inputs.items()}, 3, folds, digest, 3)
    assert all(kernels.SHARD_LAUNCHES[r].get("fri_layer") for r in range(4))
    assert got[:2] == one[:2] and torch.equal(got[5], one[5])
    for a, b in zip(got[2] + got[3] + [got[4]], one[2] + one[3] + [one[4]], strict=True):
        assert np.array_equal(a, b)
    for (_, evals, tree), (_, whole, whole_tree) in zip(got[6], one[6], strict=True):
        assert torch.equal(S.on_lead(evals), whole) and np.array_equal(tree.root, whole_tree.root)


@pytest.fixture
def second_card(dev):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    return torch.device("cuda", 1)


@pytest.mark.parametrize("kernel", ["K1", "K2", "K7", "K9"])
def test_kernel_on_the_second_card_while_the_first_is_current(second_card, kernel):
    """Each launch runs on its tensors' device, whatever device is
    current."""
    from luminair_tpu_torch import fft
    from luminair_tpu_torch.crypto.merkle import MerkleTree, open_trees

    torch.cuda.set_device(0)
    rng = np.random.default_rng(1)
    v = _rnd(rng, second_card, 3, 1 << 13)
    if kernel == "K1":
        got, want = kernels.circle_lde(kernels.circle_ifft(v), 1), kernels.circle_lde_plain(kernels.circle_ifft_plain(v), 1)
    elif kernel == "K2":
        tree = MerkleTree({13: v})
        plain = kernels.TreeDesc(kernels.tree_layers(13, second_card), {13: v})
        kernels.merkle_tree_plain(plain)
        got, want = tree.layers[0], plain.layers[0]
    elif kernel == "K7":
        point = (torch.tensor([5, 6, 7, 8]), torch.tensor([9, 10, 11, 12]))
        got = fft.eval_at_point_many([(v, point)])
        want = kernels.oods_eval_many_plain([(list(v), fft.twiddle_chain(13, point))])
    else:
        tree = MerkleTree({13: v})
        q = {13: np.unique(rng.integers(0, 1 << 13, 20))}
        plan = kernels.DecommitPass([tree.desc], [q])
        got, want = kernels.decommit(plan), kernels.decommit_plain(plan)
        assert open_trees([tree], [q])[0][1].shape[1] == 8
    assert got.device == second_card and torch.cuda.current_device() == 0
    assert torch.equal(got, want)


def test_bench_graph_prove_over_two_cards(second_card):
    """The N=16 bench graph's card PIE proved over cuda:0 and cuda:1: the
    one-device bytes, every phase's launches on both cards (the alphas,
    carries and halos cross between them in stream order)."""
    from luminair_tpu_torch import prelude as T
    from luminair_tpu_torch import serde
    from luminair_tpu_torch.parallel import sharding as S

    cx = T.Graph()
    rng = np.random.default_rng(0)
    a = cx.tensor((16, 16)).set(rng.normal(size=(16, 16)))
    b = cx.tensor((16, 16)).set(rng.normal(size=(16, 16)))
    (a * b + a).retrieve()
    cx.compile()
    settings = T.gen_circuit_settings(cx, device="cuda:0")
    pie = T.gen_trace(cx, settings, device="cuda:0")
    one = serde.proof_to_flat_bytes(T.prove(pie, settings, device="cuda:0"))
    kernels.reset_counts()
    with S.prove_mesh(S.make_chip_mesh(2)):
        got = serde.proof_to_flat_bytes(T.prove(pie, settings))
    assert got == one
    for r in range(2):
        assert all(kernels.SHARD_LAUNCHES[r].get(k) for k in ("fri_layer", "deep_quotient", "air_witness",
                                                              "air_domain")), r


def test_prover_step_over_two_cards(second_card):
    """prover_step over cuda:0 and cuda:1: the CPU's result (the second
    shard's LogUp partial copied into its row on the lead), the launches
    the plan names."""
    from luminair_tpu_torch.parallel import sharding as S

    rng = np.random.default_rng(6)
    cols = rng.integers(0, f.P, size=(16, 1 << 9), dtype=np.uint32)
    mult = rng.integers(0, f.P, size=(1 << 9,), dtype=np.uint32)
    z, alpha = rng.integers(1, f.P, 4, dtype=np.uint32), rng.integers(1, f.P, 4, dtype=np.uint32)
    mesh = S.make_chip_mesh(2)
    kernels.reset_counts()
    got = S.prover_step(mesh, cols, mult, z, alpha)
    assert {k: v for k, v in kernels.counts().items() if v} == S.step_launches(mesh, 16, 9)
    assert kernels.SHARD_LAUNCHES[1]["logup_sum"] == 1
    want = S.prover_step(S.make_chip_mesh(1, devices=["cpu"]), cols, mult, z, alpha)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# The check of many components in one launch; the carry pass of many blocks.

PINN_COMPONENTS = ["mul", "sum_reduce", "add", "exp2", "recip", "inputs", "exp2_lookup"]


def _check_comp(comp, n, rng, dev, fill, ew):
    """Random words; zeros; or small words (0 to 2: each recorded constraint
    vanishes on some rows) with the interaction and claimed sum that K5's
    twin builds from them (every LogUp constraint vanishes)."""
    tp = tape.record(comp)

    def col():
        if fill == "random":
            return _rnd(rng, dev, n)
        if fill == "honest":
            return torch.from_numpy(rng.integers(0, 3, n).astype(np.int32)).to(dev)
        return torch.zeros(n, dtype=f.I32, device=dev)

    main, pp = [col() for _ in comp.MAIN], [col() for _ in comp.PP_IDS]
    is_first = _rnd(rng, dev, n) if fill == "random" else torch.zeros(n, dtype=f.I32, device=dev)
    if fill != "random":
        is_first[0] = 1
    if fill == "honest":
        inter, claimed = tape.witness_plain(tape.record(comp, witness=True), main, pp, ew)
        return tp, main, pp, list(inter.unbind(0)), is_first, tuple(int(x) for x in claimed.cpu())
    return tp, main, pp, [col() for _ in range(4 * tp.n_relations)], is_first, _words(rng, 1)[0]


@pytest.mark.parametrize("fill", ["random", "zeros", "honest"])
@pytest.mark.parametrize("which", ["pinn", "all"])
def test_air_check_many_components_in_one_launch(dev, which, fill):
    """Every PINN component (or all 18) in one launch, each of its own size
    (1 to 2^13 rows, across CTAs): the twin's words, component by
    component, from one launch."""
    names = PINN_COMPONENTS if which == "pinn" else COMPONENT_NAMES
    rng = np.random.default_rng(300 + len(names) + ["random", "zeros", "honest"].index(fill))
    ew = _ew(rng)
    comps = [_check_comp(ALL_COMPONENTS[COMPONENT_NAMES.index(name)], 1 << int(rng.integers(0, 14)), rng, dev, fill,
                         ew) for name in names]
    before = kernels.AIR_CHECK.launches
    got = kernels.air_check_many(comps, ew)
    assert kernels.AIR_CHECK.launches - before == 1
    assert got.is_cuda and torch.equal(got, kernels.air_check_many_plain(comps, ew))


@pytest.mark.parametrize("name", list(op_graphs.GRAPHS))
def test_check_of_each_op_graph_is_one_launch(dev, name):
    """check_pie_constraints on each op graph's card PIE, honest and with
    one cell of its first table changed: one air_check launch a check, the
    CPU's dict for the same PIE."""
    from luminair_tpu_torch import prelude as T
    from luminair_tpu_torch.air.debug import check_pie_constraints
    from luminair_tpu_torch.air.pie import LuminairPie, TraceTable

    cx = _graph(name)
    settings = T.gen_circuit_settings(cx, device=dev)
    pie = T.gen_trace(cx, settings, device=dev)
    for mutate in (False, True):
        if mutate:
            table = next(t for t in pie.trace_tables.values() if t.n_rows > 1)
            column = next(iter(table.padded.values()))
            column[1] = (int(column[1]) + 1) % f.P
        kernels.reset_counts()
        got = check_pie_constraints(pie, settings)
        assert kernels.counts()["air_check"] == 1 and kernels.counts()["air_witness"] == 1
        host = LuminairPie({k: TraceTable(k, t.host_columns()) for k, t in pie.trace_tables.items()}, pie.metadata)
        assert got == check_pie_constraints(host, settings, device="cpu")
        assert mutate or got == {}


@pytest.mark.parametrize("lengths", [(1 << 12,), (3, 8, 1 << 10, 1), (1 << 14, 4, 2, 1 << 12, 5, 1 << 13)])
def test_batched_carry_pass(dev, lengths):
    """One launch over blocks of 16-byte and of single-word units: the
    batched twin's words, which are the one-block twin's block by block."""
    rng = np.random.default_rng(len(lengths))
    blocks = [_rnd(rng, dev, 4, n) for n in lengths]
    carry = _rnd(rng, dev, len(blocks), 4)
    want = [kernels.add_carry_plain(b.clone(), c) for b, c in zip(blocks, carry)]
    got = [b.clone() for b in blocks]
    before = kernels.ADD_CARRY.launches
    kernels.add_carry(got, carry)
    assert kernels.ADD_CARRY.launches - before == 1
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_witness_of_every_component_with_one_carry_pass_a_shard(dev):
    """K5 of the PINN's components (and one of fewer rows than shards) over
    4 row shards of the card: one carry pass on each shard after the
    first, none on the first; each component's interaction and claimed sum
    the twin's on its whole columns."""
    from luminair_tpu_torch.parallel import sharding as S

    rng = np.random.default_rng(17)
    ew = _ew(rng)
    comps, logs = [], [12, 11, 12, 10, 12, 9, 1]
    for name, log in zip(PINN_COMPONENTS, logs):
        comp = ALL_COMPONENTS[COMPONENT_NAMES.index(name)]
        n = 1 << log
        comps.append((tape.record(comp, witness=True), [_rnd(rng, dev, n) for _ in comp.MAIN],
                      [_rnd(rng, dev, n) for _ in comp.PP_IDS]))
    kernels.reset_counts()
    got = S.air_witness_many(_virtual("4", dev), comps, ew)
    assert {r: kernels.SHARD_LAUNCHES[r].get("add_carry", 0) for r in range(4)} == {0: 0, 1: 1, 2: 1, 3: 1}
    assert kernels.counts()["add_carry"] == 3
    for (tp, main, pp), (out, claimed) in zip(comps, got):
        want, want_claimed = tape.witness_plain(tp, main, pp, ew)
        assert torch.equal(S.on_lead(out), want) and torch.equal(claimed, want_claimed)
    assert not isinstance(got[-1][0], S.RowBlocks)  # 2 rows: on the lead, no carry


# ---------------------------------------------------------------------------
# K5 and K6: every component in one launch, compiled per component.


def _witness_comp(comp, n, rng, dev, fill, carry=False):
    tp = tape.record(comp, witness=True)

    def col():
        if fill == "random":
            return _rnd(rng, dev, n)
        if fill == "honest":
            return torch.from_numpy(rng.integers(0, 3, n).astype(np.int32)).to(dev)
        return torch.zeros(n, dtype=f.I32, device=dev)

    out = (tp, [col() for _ in comp.MAIN], [col() for _ in comp.PP_IDS])
    return out + ((_rnd(rng, dev, 4),) if carry else ())


@pytest.mark.parametrize("fill", ["random", "zeros", "honest"])
@pytest.mark.parametrize("which", ["pinn", "all"])
def test_air_witness_of_every_component_in_one_launch(dev, which, fill):
    """Every PINN component (or all 18) in one K5 launch, each of its own
    size (1 to 2^17 rows: one tile to 512, look-backs over many 32-tile
    windows), every third with a carry; three launches in a row on one
    scratch (each reads only its own epoch's flags): the twins'
    interactions and (C, 4) claimed sums, word for word."""
    names = PINN_COMPONENTS if which == "pinn" else COMPONENT_NAMES
    rng = np.random.default_rng(400 + len(names) + ["random", "zeros", "honest"].index(fill))
    ew = _ew(rng)
    comps = [_witness_comp(ALL_COMPONENTS[COMPONENT_NAMES.index(name)], 1 << int(rng.integers(0, 18)), rng, dev,
                           fill, carry=i % 3 == 1) for i, name in enumerate(names)]
    want, want_claimed = kernels.air_witness_many_plain(comps, ew)
    for _ in range(3):
        before = kernels.AIR_WITNESS.launches
        outs, claimed = kernels.air_witness_many(comps, ew)
        assert kernels.AIR_WITNESS.launches - before == 1
        assert all(torch.equal(g, w) for g, w in zip(outs, want)) and torch.equal(claimed, want_claimed)


def _domain_term(comp, m, rng, dev, fill, ew, start, alpha):
    tp = tape.record(comp)
    if fill == "honest":
        main = [torch.from_numpy(rng.integers(0, 3, m).astype(np.int32)).to(dev) for _ in comp.MAIN]
        pp = [torch.from_numpy(rng.integers(0, 3, m).astype(np.int32)).to(dev) for _ in comp.PP_IDS]
        inter, claimed = tape.witness_plain(tape.record(comp, witness=True), main, pp, ew)
        inter, claimed = [c.contiguous() for c in inter.unbind(0)], tuple(int(x) for x in claimed.cpu())
        is_first = torch.zeros(m, dtype=f.I32, device=dev)
        is_first[0] = 1
    else:
        main, pp = [_rnd(rng, dev, m) for _ in comp.MAIN], [_rnd(rng, dev, m) for _ in comp.PP_IDS]
        inter, is_first, claimed = [_rnd(rng, dev, m) for _ in range(4 * tp.n_relations)], _rnd(rng, dev, m), \
            _words(rng, 1)[0]
    pows, nxt = f.qm31_powers_ints(start, alpha, tp.n_pows)
    return kernels.DomainTerm(tp, main, pp, inter, is_first, claimed, pows), nxt


def _row_blocks(blk, shards):
    m, stride = blk.rows, blk.stride
    R = m // shards
    out = []
    for r in range(shards):
        part, nxt0, prev0 = slice(r * R, (r + 1) * R), ((r + 1) % shards) * R, (r * R - stride) % m
        terms = [kernels.DomainTerm(t.tp, [c[part] for c in t.main], [c[part] for c in t.pp],
                                    [c[part] for c in t.inter], t.is_first[part], t.claimed, t.pows,
                                    ({x: t.main[x][nxt0 : nxt0 + stride] for x in t.tp.next_cols},
                                     [c[prev0 : prev0 + stride] for c in t.inter[-4:]])) for t in blk.terms]
        out.append(kernels.DomainBlock(terms, blk.log_trace, stride, r * R, m.bit_length() - 1))
    return out


@pytest.mark.parametrize("fill", ["random", "honest"])
@pytest.mark.parametrize("blowup", [1, 2, 4])
def test_air_domain_of_every_component_in_one_launch(dev, blowup, fill):
    """All 18 components grouped by trace log (1 to 13) into commit
    domains, the alpha powers running on from one to the next: one K6
    launch whose each domain's quotients are the sum of its components'
    twins; then the largest domain in 4 row blocks with their halos, a
    launch a block, the first with every other domain whole (a mesh's
    lead)."""
    rng = np.random.default_rng(500 + blowup + len(fill))
    ew = _ew(rng)
    start, alpha = _words(rng, 2)
    logs = {c.name: int(rng.integers(1, 13)) for c in ALL_COMPONENTS}
    logs["mul"] = logs["sum_reduce"] = logs["max_reduce"] = 13
    by_log = {}
    for comp in ALL_COMPONENTS:
        term, start = _domain_term(comp, 1 << (logs[comp.name] + blowup), rng, dev, fill, ew, start, alpha)
        by_log.setdefault(logs[comp.name], []).append(term)
    blocks = [kernels.DomainBlock(terms, log, 1 << blowup) for log, terms in sorted(by_log.items())]
    want = kernels.air_domain_many_plain(blocks, ew)
    before = kernels.AIR_DOMAIN.launches
    got = kernels.air_domain_many(blocks, ew)
    assert kernels.AIR_DOMAIN.launches - before == 1
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    rows = _row_blocks(blocks[-1], 4)
    lead = kernels.air_domain_many([rows[0]] + blocks[:-1], ew)
    parts = [lead[0]] + [kernels.air_domain_many([b], ew)[0] for b in rows[1:]]
    assert torch.equal(torch.cat(parts), want[-1])
    assert all(torch.equal(g, w) for g, w in zip(lead[1:], want[:-1]))


@pytest.mark.parametrize("shards", [2, 4])
def test_prove_on_a_virtual_mesh_launches_k5_and_k6_once_a_shard(dev, shards):
    """all_ops's card PIE over 2 and 4 shards of the card: K5 and K6 one
    launch a row shard, the carry pass one on each but the first, and the
    one-device bytes (whose prove makes one K5 and one K6 launch)."""
    from luminair_tpu_torch import prelude as T
    from luminair_tpu_torch import serde
    from luminair_tpu_torch.parallel import sharding as S

    cx = _graph("all_ops")
    settings = T.gen_circuit_settings(cx)
    pie = T.gen_trace(cx, settings)
    kernels.reset_counts()
    one = serde.proof_to_flat_bytes(T.prove(pie, settings, device=dev))
    assert kernels.AIR_WITNESS.launches == 1 and kernels.AIR_DOMAIN.launches == 1
    kernels.reset_counts()
    with S.prove_mesh(_virtual(str(shards), dev)):
        assert serde.proof_to_flat_bytes(T.prove(pie, settings)) == one
    for r in range(shards):
        got = {k: kernels.SHARD_LAUNCHES[r].get(k, 0) for k in ("air_witness", "air_domain", "add_carry")}
        assert got == {"air_witness": 1, "air_domain": 1, "add_carry": int(r > 0)}, (r, kernels.SHARD_LAUNCHES)
