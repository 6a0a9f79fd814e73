"""The frozen counts of work, against hand computations for a small
statement, and the same for any plan of launches the program makes."""

import json

import pytest

from conftest import ROOT, SEED


def _mul_add(n):
    from portbench.reference import mul_add
    from portbench import checks

    a = {"a": __import__("numpy").ones((n, n)), "b": __import__("numpy").ones((n, n))}
    return checks.statement_of(mul_add.forward({"n": n}, {}, a)[1])


def test_statement_of_a_small_graph_by_hand():
    from portbench.statement import Pcs

    st = _mul_add(4)
    assert st.rows == {"inputs": 32, "mul": 16, "add": 16}
    assert st.claim == {"add": 4, "mul": 4, "inputs": 5}
    assert st.cells == 32 * 7 + 16 * 16 + 16 * 15 == 720
    assert st.trees(1) == [{4: 1, 5: 1}, {4: 31, 5: 7}, {4: 24, 5: 4}, {6: 4}]
    pcs = Pcs(5, 1, 15, 2, 4)
    # smallest commit log 5: the last layer's bound clamps to 5 - 1 - 1 = 3, its line log to 4
    assert st.last_layer_bound(pcs) == 3 and st.fri_layers(pcs) == [6]


def test_work_of_one_transform_and_one_tree_by_hand():
    from portbench import work

    w = work.lde(4, 1, 1)
    # interpolation: 16 words read, 16 written; 4 stages x 8 butterflies x 12 + 16 scalings x 6
    # evaluation: 16 read, 32 written; 2 cosets x 4 stages x 8 butterflies x 12
    assert (w.n_bytes, w.n_ops) == (8 * 16 + 4 * 16 + 4 * 32, 4 * 8 * 12 + 16 * 6 + 2 * 4 * 8 * 12)
    assert (work.lde(4, 3, 1).n_bytes, work.lde(4, 3, 1).n_ops) == (3 * w.n_bytes, 3 * w.n_ops)
    t = work.merkle({5: 4})
    # 32 leaves of 4 words (one compression each), 31 inner nodes of 16 words; 63 digests
    assert (t.n_bytes, t.n_ops) == (4 * 4 * 32 + 32 * 63, 63 * 968)
    mixed = work.merkle({5: 4, 4: 20})
    # the 16 nodes of layer 4 hash 16 + 20 words: 3 compressions each
    assert mixed.n_ops == (32 + 16 * 3 + 15) * 968
    assert w.seconds == max(w.n_bytes / 3.35e12, w.n_ops / 33.5e12)


def test_request_work_sums_its_parts():
    from portbench import work
    from portbench.statement import Pcs

    st, pcs = _mul_add(4), Pcs(5, 1, 15, 2, 4)
    parts = work.request(st, pcs)
    assert parts["trace"].n_bytes == 4 * 720
    lde = sum(work.lde(log, c, 1).n_ops for tree in st.trees(1) for log, c in tree.items())
    assert parts["lde"].n_ops == lde
    merkle = sum(work.merkle({l + 1: c for l, c in tree.items()}).n_ops for tree in st.trees(1)) + work.merkle({6: 4}).n_ops
    assert parts["merkle"].n_ops == merkle
    assert work.total(parts).n_bytes == sum(p.n_bytes for p in parts.values())


@pytest.mark.parametrize("shards", [1, 2])
def test_the_statement_holds_whichever_launches_prove_it(shards):
    """The counts read the statement only; a prove over one device and one
    over a mesh of two shards (other launches, other blocks) state the same
    claim, which the statement predicts."""
    import numpy as np

    from luminair_tpu_torch import prelude as T, serde
    from luminair_tpu_torch.parallel import sharding
    from portbench import checks, work
    from portbench.reference import mul_add, proof
    from portbench.statement import INDEX, Pcs

    rng = np.random.default_rng(SEED)
    a, b = rng.normal(size=(8, 8)), rng.normal(size=(8, 8))
    st = checks.statement_of(mul_add.forward({"n": 8}, {}, {"a": a, "b": b})[1])
    cx = T.Graph()
    ta, tb = cx.tensor((8, 8)).set(a), cx.tensor((8, 8)).set(b)
    (ta * tb + ta).retrieve()
    cx.compile()
    s = T.gen_circuit_settings(cx, device="cpu")
    pie = T.gen_trace(cx, s, device="cpu")
    if shards == 1:
        p = T.prove(pie, s, device="cpu")
    else:
        with sharding.prove_mesh(sharding.make_chip_mesh(shards, devices=["cpu"] * shards)):
            p = T.prove(pie, s)
    _, claim = proof.header(serde.proof_to_flat_bytes(p))
    assert claim == {INDEX[n]: log for n, log in st.claim.items()}
    assert {k: (t.n_rows) for k, t in pie.trace_tables.items()} == st.rows
    assert work.request(st, Pcs(5, 1, 15, 2, 4))["merkle"].n_ops > 0
