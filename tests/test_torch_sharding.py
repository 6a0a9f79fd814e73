"""luminair_tpu_torch.parallel.sharding on virtual CPU meshes against the
reference package's parallel/sharding.py.

tests/conftest.py gives JAX 8 virtual CPU devices, so the reference's
`prover_step` runs on a real jax.sharding.Mesh; the port's meshes repeat
the CPU device (n shards on one device: the split, the reshard, the
per-shard calls and the merge, but no copy between cards).  Inputs come
from numpy seeds and go to both sides; tolerance 0 throughout, but for
the float32 forward (1e-5).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from luminair_tpu import prelude as R
from luminair_tpu import serde as ref_serde
from luminair_tpu.crypto import merkle as ref_merkle
from luminair_tpu.parallel import accel
from luminair_tpu.parallel import sharding as RS
from luminair_tpu.verifier import verify as ref_verify
from luminair_tpu_torch import fields as f
from luminair_tpu_torch import graft_entry, kernels, serde
from luminair_tpu_torch import prelude as T
from luminair_tpu_torch.crypto.merkle import MerkleTree, ShardedMerkleTree, open_trees, verify_decommitment
from luminair_tpu_torch.errors import KernelError, ProverError
from luminair_tpu_torch.models import op_graphs
from luminair_tpu_torch.parallel import sharding as S
from tests import test_device_trace as ref_graphs

CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small tensors prove faster on one thread, and the suite's workers do
    not then compete for the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def host_reference():
    """The reference's host path (its device engine off, restored)."""
    was = accel.enabled()
    accel.enable(False)
    yield
    accel.enable(was)


def _inputs(n_cols=8, log_n=5, seed=7):
    """The reference test's inputs (tests/test_sharding.py)."""
    rng = np.random.default_rng(seed)
    cols = rng.integers(0, (1 << 31) - 1, size=(n_cols, 1 << log_n), dtype=np.uint32)
    mult = rng.integers(0, (1 << 31) - 1, size=(1 << log_n,), dtype=np.uint32)
    z = rng.integers(1, (1 << 31) - 1, size=(4,), dtype=np.uint32)
    alpha = rng.integers(1, (1 << 31) - 1, size=(4,), dtype=np.uint32)
    return cols, mult, z, alpha


def _cpu_mesh(n):
    return S.make_chip_mesh(n, devices=[CPU] * n)


def _assert_step(got, want):
    for g, w in zip(got, want):
        assert g.dtype == np.uint32
        np.testing.assert_array_equal(g, np.asarray(w, dtype=np.uint32))


@pytest.mark.parametrize("log_blowup", [1, 2])
@pytest.mark.parametrize("shape", [(4, 2), (2, 4)])
def test_prover_step_matches_reference_mesh(shape, log_blowup, host_reference):
    """('rows', 'cols') meshes of the same shape on both sides, and the
    reference's host step."""
    cols, mult, z, alpha = _inputs()
    want = RS.prover_step(RS.make_mesh(8, shape), cols, mult, z, alpha, log_blowup=log_blowup)
    got = S.prover_step(S.make_mesh(8, shape, devices=[CPU] * 8), cols, mult, z, alpha, log_blowup=log_blowup)
    _assert_step(got, want)
    _assert_step(got, RS.host_reference_step(cols, mult, z, alpha, log_blowup=log_blowup))


@pytest.mark.parametrize("log_blowup", [1, 2])
@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_prover_step_1d_matches_host_reference(n, log_blowup, host_reference):
    """1-D meshes; one shard gives the single-device result.  Also the
    reference's step with its rows over n devices (an (n, 1) ('rows',
    'cols') mesh)."""
    cols, mult, z, alpha = _inputs(seed=11 + n)
    got = S.prover_step(_cpu_mesh(n), cols, mult, z, alpha, log_blowup=log_blowup)
    _assert_step(got, RS.host_reference_step(cols, mult, z, alpha, log_blowup=log_blowup))
    _assert_step(got, RS.prover_step(RS.make_mesh(n, (n, 1)), cols, mult, z, alpha, log_blowup=log_blowup))


@pytest.mark.parametrize("k", [1, 2, 3, 8])
def test_logup_sum_plain_matches_reference_body(k):
    """The twin against the reference's `_logup_sum_body`, jitted on its
    ('rows', 'cols') mesh."""
    cols, mult, z, alpha = _inputs(n_cols=max(k, 2), log_n=6, seed=100 + k)
    mesh = RS.make_mesh(8, (4, 2))
    want = jax.jit(lambda v, m, zz, a: RS._logup_sum_body(v, m, zz, a, mesh))(cols[:k], mult, z, alpha)
    got = kernels.logup_sum(torch.from_numpy(cols[:k].view(np.int32)), torch.from_numpy(mult.view(np.int32)), z,
                            alpha)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), np.asarray(want))


def test_logup_plan_used_for_two_challenges():
    """Two plans of other (z, alpha), called in turns on four row blocks
    each (into rows of one result, and not), each time the twin's sum; a
    plan's launch parameters hold its own z and alpha's powers (the
    reference's QM31 arithmetic)."""
    from luminair_tpu.fields import qm31

    cols, mult, z, alpha = _inputs(n_cols=3, log_n=8, seed=41)
    _, _, z2, alpha2 = _inputs(seed=42)
    v, m = torch.from_numpy(cols.view(np.int32)), torch.from_numpy(mult.view(np.int32))
    plans = [kernels.LogupPlan(z, alpha, 3), kernels.LogupPlan(z2, alpha2, 3)]
    out = torch.zeros((4, 4), dtype=torch.int32)
    for r in range(4):
        rows = slice(64 * r, 64 * (r + 1))
        for plan, zz, aa in zip(plans, (z, z2), (alpha, alpha2)):
            want = kernels.logup_sum_plain(v[:, rows], m[rows], zz, aa)
            assert torch.equal(plan(v[:, rows], m[rows]), want)
            plan(v[:, rows], m[rows], out[r])
            assert torch.equal(out[r], want)
    for plan, zz, aa in zip(plans, (z, z2), (alpha, alpha2)):
        a, p = plan.args(), qm31.one()
        assert list(a.z) == zz.tolist() and a.k == 3
        for k in range(3):
            assert list(a.pows[4 * k : 4 * k + 4]) == np.asarray(p).tolist()
            p = qm31.mul(p, aa)
        assert not any(a.pows[12:])


@pytest.mark.parametrize("s", [1, 2, 3, 4, 8, 64])
def test_lead_sum_equals_the_sequential_adds(s):
    """One reduction mod P of S partials against S - 1 adds in turn, on
    QM31 words near P and random ones."""
    rng = np.random.default_rng(s)
    words = np.where(rng.random((s, 4)) < 0.5, (1 << 31) - 2 - rng.integers(0, 4, (s, 4)),
                     rng.integers(0, (1 << 31) - 1, (s, 4)))
    parts = torch.from_numpy(words.astype(np.int32))
    want = torch.zeros(4, dtype=torch.int64)
    for row in parts:
        want = f.add(want, row.to(torch.int64))
    assert torch.equal(S.lead_sum(parts), want.to(torch.int32))


def test_logup_sum_checks_its_inputs():
    cols, mult, z, alpha = _inputs(n_cols=kernels.LOGUP_MAX_K + 1)
    v, m = torch.from_numpy(cols.view(np.int32)), torch.from_numpy(mult.view(np.int32))
    with pytest.raises(KernelError):
        kernels.logup_sum(v, m, z, alpha)  # more relation columns than a launch takes
    with pytest.raises(KernelError):
        kernels.logup_sum(v[:2], m[:-1], z, alpha)
    with pytest.raises(KernelError):
        kernels.logup_sum(v[:2].t(), m, z, alpha)


# --- the whole prove under prove_mesh ------------------------------------

CFG = dict(pow_bits=2, log_last_layer_degree_bound=0, n_queries=8)


def _config(pkg, log_blowup=1):
    return pkg.PcsConfig(pow_bits=CFG["pow_bits"], fri=pkg.FriConfig(
        log_blowup_factor=log_blowup, log_last_layer_degree_bound=CFG["log_last_layer_degree_bound"],
        n_queries=CFG["n_queries"]))


def _ab_graph(pkg, n, seed):
    cx = pkg.Graph()
    rng = np.random.default_rng(seed)
    a = cx.tensor((n, n)).set(rng.normal(size=(n, n)))
    b = cx.tensor((n, n)).set(rng.normal(size=(n, n)))
    (a * b + a).retrieve()
    cx.compile()
    return cx


def _all_ops(pkg):
    cx = pkg.Graph()
    if pkg is R:
        ref_graphs.build_all_ops(cx, ref_graphs.DATA)
    else:
        op_graphs.GRAPHS["all_ops"](cx, op_graphs.DATA)
    cx.compile()
    return cx


def _check_mesh_proof(build, mesh, log_blowup=1):
    """The port's proof under `mesh` against the reference's host proof of
    the same graph: the same bytes, accepted by the reference verifier."""
    rcx = build(R)
    rs = R.gen_circuit_settings(rcx, device=False)
    ref_bytes = ref_serde.proof_to_flat_bytes(R.prove(R.gen_trace(rcx, rs, device=False), rs, _config(R, log_blowup)))
    cx = build(T)
    settings = T.gen_circuit_settings(cx, device="cpu")
    pie = T.gen_trace(cx, settings, device="cpu")
    with S.prove_mesh(mesh):
        proof = T.prove(pie, settings, _config(T, log_blowup))
    assert serde.proof_to_flat_bytes(proof) == ref_bytes
    assert ref_verify(ref_serde.proof_from_payload(serde.proof_to_payload(proof)), rs)


@pytest.mark.parametrize("n_dev", [2, 4, 8])
@pytest.mark.parametrize("n,seed", [(8, 5), (64, 17)])
def test_sharded_prove_matches_reference(n, seed, n_dev, host_reference):
    _check_mesh_proof(lambda pkg: _ab_graph(pkg, n, seed), _cpu_mesh(n_dev))


def test_hosts_chips_mesh_prove_matches_reference(host_reference):
    mesh = S.make_host_chip_mesh(2, 4, devices=[CPU] * 8)
    assert mesh.axis_names == ("hosts", "chips") and mesh.devices.shape == (2, 4)
    _check_mesh_proof(lambda pkg: _ab_graph(pkg, 16, 29), mesh)


@pytest.mark.parametrize("log_blowup", [1, 2])
def test_all_ops_sharded_prove_matches_reference(log_blowup, host_reference):
    _check_mesh_proof(_all_ops, _cpu_mesh(4), log_blowup)


def test_prove_under_a_mesh_runs_on_its_lead():
    cx = _ab_graph(T, 8, 5)
    settings = T.gen_circuit_settings(cx, device="cpu")
    pie = T.gen_trace(cx, settings, device="cpu")
    with S.prove_mesh(_cpu_mesh(2)):
        with pytest.raises(ProverError):
            T.prove(pie, settings, _config(T), device="cuda")  # not the lead (and no card here)
    with pytest.raises(ProverError):
        with S.prove_mesh(S.make_chip_mesh(3, devices=[CPU] * 3)):
            pass  # rows split over a power of two of devices


# --- trees and the reshard ------------------------------------------------


@pytest.mark.parametrize("n", [2, 4, 8, 16, 64])
def test_sharded_tree_with_columns_below_the_shard_count(n, host_reference):
    """Columns of logs 9, 7 and 2 over n row shards: the smallest has fewer
    rows than shards at n >= 8 (and joins on layer log2(n) itself at n =
    4).  The root and the opening (values, witness) equal the whole
    tree's and the reference's."""
    rng = np.random.default_rng(n)
    spec = [(9, 3), (7, 2), (2, 1)]
    host = {log: rng.integers(0, (1 << 31) - 1, size=(k, 1 << log), dtype=np.uint32) for log, k in spec}
    cols = {log: torch.from_numpy(c.view(np.int32)) for log, c in host.items()}
    s = n.bit_length() - 1
    shard_cols = [{log: c[:, r * (c.shape[1] // n) : (r + 1) * (c.shape[1] // n)].contiguous()
                   for log, c in cols.items() if (1 << log) >= n} for r in range(n)]
    tree = ShardedMerkleTree(shard_cols, {log: c for log, c in cols.items() if (1 << log) < n}, CPU)
    assert tree.log_shards == s and len(tree.shards) == n
    ref = ref_merkle.MerkleTree([c for log, _ in spec for c in host[log]])
    np.testing.assert_array_equal(tree.root, ref.root)
    queries = {9: np.unique(rng.integers(0, 512, 12)), 7: np.unique(rng.integers(0, 128, 3)), 2: np.array([0, 3])}
    (values, witness), (whole_values, whole_witness) = open_trees([tree, MerkleTree(cols)], [queries, queries])
    np.testing.assert_array_equal(witness, np.asarray(ref.decommit(queries), dtype=np.uint32).reshape(-1, 8))
    np.testing.assert_array_equal(witness, whole_witness)
    for got, whole, want in zip(values, whole_values, ref.queried_values(queries), strict=True):
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, whole)
    logs = [log for log, k in spec for _ in range(k)]
    assert verify_decommitment(tree.root, logs, queries, values, witness)


@pytest.mark.parametrize("n", [2, 8])
def test_sharded_tree_channel_step_in_the_top_root_pass(n):
    """A FRI layer's channel step (mix the root, draw the alpha) in the
    top's root pass: the state and slot of the whole tree's."""
    rng = np.random.default_rng(40 + n)
    layer = torch.from_numpy(rng.integers(0, (1 << 31) - 1, size=(1 << 6, 4), dtype=np.uint32).view(np.int32))
    state = torch.from_numpy(rng.integers(0, 1 << 31, size=kernels.CHANNEL_WORDS, dtype=np.uint32).view(np.int32))
    want_state, want_slot = state.clone(), torch.zeros(12, dtype=torch.int32)
    whole = MerkleTree({6: layer.t()}, want_state, want_slot)
    got_state, got_slot = state.clone(), torch.zeros(12, dtype=torch.int32)
    rows = 64 // n
    tree = ShardedMerkleTree([{6: layer[r * rows : (r + 1) * rows].t()} for r in range(n)], {}, CPU, got_state,
                             got_slot)
    np.testing.assert_array_equal(tree.root, whole.root)
    assert torch.equal(got_state, want_state) and torch.equal(got_slot, want_slot)
    assert not torch.equal(got_state, state)


@pytest.mark.parametrize("mesh", ["1d2", "1d4", "1d8", "rows_cols_2x4", "rows_cols_4x2"])
def test_reshard_moves_a_block_exchange(mesh):
    """The reshard moves (n - 1)/n of the tree's words, no more (a block
    stays where its column and row shards meet), and the lead gathers
    nothing in prover_step."""
    if mesh.startswith("1d"):
        m = _cpu_mesh(int(mesh[2:]))
    else:
        r, c = (int(x) for x in mesh.split("_")[-1].split("x"))
        m = S.make_mesh(r * c, (r, c), devices=[CPU] * (r * c))
    cols, mult, z, alpha = _inputs(n_cols=12, log_n=6)
    stats = {}
    S.prover_step(m, cols, mult, z, alpha, stats=stats)
    n = m.size
    assert stats["tree_bytes"] == 4 * 12 << 7
    assert stats["moved_bytes"] * n == stats["tree_bytes"] * (n - 1)


def test_column_shards_of_a_rows_cols_mesh_split_over_cols_first():
    m = S.make_mesh(8, (4, 2), devices=[CPU] * 8)
    assert [p for p, _ in m.row_shards()] == list(range(8))
    assert [p for p, _ in m.col_shards()] == [0, 2, 4, 6, 1, 3, 5, 7]
    assert S.make_mesh(devices=[CPU] * 6).shape == {"rows": 3, "cols": 2}


def test_make_chip_mesh_never_falls_back():
    """Fewer CUDA devices than asked (none here) raise; no CPU in their
    place."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for make in (lambda: S.make_chip_mesh(2), lambda: S.make_chip_mesh(), lambda: S.make_host_chip_mesh(2, 2),
                 lambda: S.make_mesh(4)):
        with pytest.raises(ProverError):
            make()
    with pytest.raises(ProverError):
        S.make_chip_mesh(3, devices=[CPU] * 2)


# --- the dry run ------------------------------------------------------------


def test_entry_forward_matches_reference():
    import __graft_entry__ as ref_entry

    fn, (params, x) = ref_entry.entry()
    want = np.asarray(fn(params, x))
    module, xt = graft_entry.entry("cpu")
    np.testing.assert_array_equal(xt.numpy(), np.asarray(x))
    got = module(xt).detach().numpy()
    assert got.shape == (1024, 1)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_dryrun_multichip_on_cpu_shards(capsys):
    out = graft_entry.dryrun_multichip(4, device="cpu")
    printed = capsys.readouterr().out
    assert "dryrun_multichip OK" in printed and "virtual=true" in printed
    assert out["virtual"] and out["devices"] == ["cpu"] * 4
    assert out["meshes"] == [{"chips": 4}, {"hosts": 2, "chips": 2}]
    assert out["forward_rel_err"] <= 1e-5
