"""The port's verifier (luminair_tpu_torch.verifier.verify, on the CPU)
against the reference package's, verdict for verdict: honest proofs of
both packages, one parametrised test of tampered proofs, the mutated PIEs
of test_adversarial.py proved by each package and verified by each, the
two round-5 forgeries (which both verifiers accept), and the verifier's
parts -- Merkle path check, twiddles at positions, quotients at positions,
FRI query check, last-layer evaluation, LUT validation -- against the
reference's.  Tolerance 0: verdicts, error classes, booleans and field
values must be equal."""

import copy

import numpy as np
import pytest
import torch

from luminair_tpu import prelude as R
from luminair_tpu import serde as ref_serde
from luminair_tpu.air import preprocessed as ref_pp
from luminair_tpu.crypto.merkle import MerkleTree as RefMerkleTree
from luminair_tpu.crypto.merkle import verify_decommitment as ref_verify_decommitment
from luminair_tpu.fft import line_eval_at_x as ref_line_eval_at_x
from luminair_tpu.parallel import accel
from luminair_tpu.pcs import fri as ref_fri
from luminair_tpu.pcs import scheme as ref_scheme
from luminair_tpu_torch import fields as f
from luminair_tpu_torch import fft, kernels, serde, verifier
from luminair_tpu_torch import prelude as T
from luminair_tpu_torch.air import preprocessed, tape
from luminair_tpu_torch.air.settings import CircuitSettings
from luminair_tpu_torch.crypto import blake2s
from luminair_tpu_torch.crypto.merkle import verify_decommitment
from luminair_tpu_torch.pcs import fri
from luminair_tpu_torch.pcs.config import PcsConfig
from luminair_tpu_torch.pcs.quotients import ColumnSample, quotients_at_positions
from tests import test_adversarial as adv
from tests.test_torch_serde import CASES, make_cases

P = (1 << 31) - 1


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """These small tensors prove faster on one CPU thread, and the suite's
    workers do not then compete for the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def cases():
    return make_cases()


@pytest.fixture(autouse=True)
def host_reference():
    """The reference on its host path for every test here."""
    was = accel.enabled()
    accel.enable(False)
    yield
    accel.enable(was)


def _verdict(fn) -> str:
    """'accepted', or the class name of what `fn` raised."""
    try:
        assert fn() is True
        return "accepted"
    except AssertionError:
        raise
    except Exception as e:  # the verdict is the class, compared across packages
        return type(e).__name__


def _security(case, pkg) -> dict:
    """An 80-bit case is verified against its profile and 80 bits."""
    return {"expected_config": CASES[case][1](pkg), "min_security_bits": 80} if "hs" in case else {}


def _port_proof(ref_proof):
    """A reference proof as the port reads it (its payload through the
    port's serde)."""
    return serde.proof_from_payload(ref_serde.proof_to_payload(ref_proof))


def _port_settings(ref_settings):
    return CircuitSettings.from_dict(ref_settings.to_dict())


@pytest.mark.parametrize("whose", ["port", "reference"])
@pytest.mark.parametrize("case", list(CASES))
def test_verify_accepts_honest_proofs(cases, tmp_path, case, whose):
    """Both packages' proofs of every case; the reference's read from its
    proof and settings files."""
    if whose == "port":
        settings, _, proof = cases[case][1]
    else:
        ref_settings, _, ref_proof = cases[case][0]
        ref_serde.proof_to_file(ref_proof, str(tmp_path / "p.npz"))
        ref_settings.to_json_file(str(tmp_path / "s.json"))
        proof = serde.proof_from_file(str(tmp_path / "p.npz"))
        settings = CircuitSettings.from_json_file(str(tmp_path / "s.json"))
    assert T.verify(proof, settings, device="cpu", **_security(case, T)) is True


def _flip(a):
    np.asarray(a).view(np.uint8)[1] ^= 0x01  # one byte


def _first_component(p):
    return next(iter(p["claim"]))


def _raise_last_layer_bound(p):
    """The FRI last layer above the smallest input's line level, its
    coefficient count grown to match: only the check that every input is
    folded in rejects it."""
    d = min(p["claim"].values())
    p["config"]["fri"]["log_last_layer_degree_bound"] = d
    coeffs = p["pcs"]["fri"]["last_layer_coeffs"]
    grown = np.zeros((1 << d, 4), dtype=np.uint32)
    grown[: len(coeffs)] = coeffs
    p["pcs"]["fri"]["last_layer_coeffs"] = grown


def _bump_nonce(p):
    p["pcs"]["pow_nonce"] += 1
    p["pcs"]["fri"]["pow_nonce"] += 1


def _bump_sum(p):
    s = p["interaction_claim"][_first_component(p)]
    s[0] = (s[0] + 1) % P


def _bump_log_size(p):
    p["claim"][_first_component(p)] += 1


def _bend_lut(s):
    outs = np.array(s.lookups.exp2.outputs, copy=True)
    outs[len(outs) // 2] += 1 << 20  # far beyond one step + 2^-48 relative
    s.lookups.exp2.outputs = outs


#: site -> (payload tamper, settings tamper, verify keywords, the verdict).
SITES = {
    **{f"root{i}": (lambda p, i=i: _flip(p["roots"][i]), None, {}, "StwoVerifierError") for i in range(4)},
    "sampled_value": (lambda p: _flip(p["pcs"]["sampled_values"][1][3][0]), None, {}, "StwoVerifierError"),
    "tree_value": (lambda p: _flip(p["pcs"]["tree_queried_values"][1][0]), None, {}, "StwoVerifierError"),
    "tree_witness": (lambda p: _flip(p["pcs"]["tree_witnesses"][1][0]), None, {}, "StwoVerifierError"),
    "tree_trailing_witness": (lambda p: p["pcs"]["tree_witnesses"][1].append(p["pcs"]["tree_witnesses"][1][0].copy()),
                              None, {}, "StwoVerifierError"),
    "fri_root": (lambda p: _flip(p["pcs"]["fri"]["layer_roots"][0]), None, {}, "StwoVerifierError"),
    "fri_value": (lambda p: _flip(p["pcs"]["fri"]["layer_queried_values"][0][0]), None, {}, "StwoVerifierError"),
    "fri_witness": (lambda p: _flip(p["pcs"]["fri"]["layer_witnesses"][0][0]), None, {}, "StwoVerifierError"),
    "last_layer_coeff": (lambda p: _flip(p["pcs"]["fri"]["last_layer_coeffs"]), None, {}, "StwoVerifierError"),
    "pow_nonce": (_bump_nonce, None, {}, "StwoVerifierError"),
    "logup_sum": (_bump_sum, None, {}, "InvalidLogUpError"),
    "claim_log_size": (_bump_log_size, None, {}, "StwoVerifierError"),
    "last_layer_bound": (_raise_last_layer_bound, None, {}, "StwoVerifierError"),
    "expected_config": (None, None, {"expected_config": "high_security"}, "StwoVerifierError"),
    "min_security_bits": (None, None, {"min_security_bits": 80}, "StwoVerifierError"),
    "lut_output": (None, _bend_lut, {}, "StwoVerifierError"),
}
TAMPER_CASES = [(case, site) for case in ("bench8_b1", "bench8_b2", "all_ops") for site in SITES
                if site != "lut_output" or case == "all_ops"] + [("pinn", "lut_output")]


@pytest.mark.parametrize("case,site", TAMPER_CASES)
def test_tampered_proof_verdicts_match_reference(cases, case, site):
    tamper, bend, kw, want = SITES[site]
    ref_settings, _, ref_proof = cases[case][0]
    payload = copy.deepcopy(ref_serde.proof_to_payload(ref_proof))
    if tamper is not None:
        tamper(payload)
    settings = copy.deepcopy(ref_settings)
    if bend is not None:
        bend(settings)
    verdicts = []
    for pkg, proof, s in ((R, ref_serde.proof_from_payload(payload), settings),
                          (T, serde.proof_from_payload(payload), _port_settings(settings))):
        opts = {k: (pkg.PcsConfig.high_security() if v == "high_security" else v) for k, v in kw.items()}
        if pkg is T:
            opts["device"] = "cpu"
        verdicts.append(_verdict(lambda: pkg.verify(proof, s, **opts)))
    assert verdicts == [want, want]


CFG = {pkg: pkg.PcsConfig(pow_bits=1, fri=pkg.FriConfig(log_blowup_factor=1, log_last_layer_degree_bound=0,
                                                        n_queries=8)) for pkg in (R, T)}


def _binary(op):
    def build(cx, rng):
        a = cx.tensor((4, 4)).set(rng.uniform(0.3, 1.2, (4, 4)))
        b = cx.tensor((4, 4)).set(rng.uniform(0.3, 1.2, (4, 4)))
        {"add": lambda: a + b, "mul": lambda: a * b, "rem": lambda: a % b, "less_than": lambda: a < b}[op]().retrieve()

    return build


def _unary(op):
    def build(cx, rng):
        getattr(cx.tensor((4, 4)).set(rng.uniform(0.3, 1.2, (4, 4))), op)().retrieve()

    return build


def _reduce(op, values=None):
    def build(cx, rng):
        data = rng.uniform(0.1, 1.0, (4, 8)) if values is None else np.array([values])
        getattr(cx.tensor(data.shape).set(data), op)(1).retrieve()

    return build


def _contiguous(cx, rng):
    (cx.tensor((4, 4)).set(rng.uniform(0.1, 1.0, (4, 4))).slice_dim(1, 0, 2).contiguous() * 1.0).retrieve()


def _slice_shrink(cx, rng):
    (cx.tensor((4, 4)).set(rng.uniform(0.1, 1.0, (4, 4))).slice_dim(1, 0, 1).contiguous() * 2.0).retrieve()


def _expand_grow(cx, rng):
    (cx.tensor((4, 1)).set(rng.uniform(0.1, 1.0, (4, 1))).expand(1, 4).contiguous() + 0.5).retrieve()


def _honest_reduce(cx, rng):
    a = cx.tensor((3, 5)).set(rng.uniform(-0.8, 0.9, (3, 5)))
    (a.max_reduce(1) + a.sum_reduce(1)).retrieve()


def _column(table, column, row=1):
    return lambda pie, s: adv.mutate(pie, table, column, row)


def _multiplicity(table, moved=False, index=None):
    def mutate(pie, settings):
        t = pie.trace_tables[table]
        col = t.columns["multiplicity"].copy()
        nz = np.nonzero(col)[0]
        if index is not None:
            col[index] += 1
        elif moved:
            other = (nz[0] + 1) % len(col)
            if other in nz and len(nz) > 1:
                other = (nz[-1] + 1) % len(col)
            col[nz[0]] -= 1
            col[other] += 1
        else:
            col[nz[0]] += 1
        t.columns["multiplicity"] = col

    return mutate


def _max_chain(pick):
    def mutate(pie, settings):
        inp = pie.trace_tables["max_reduce"].columns["input"].astype(np.int64)
        adv.TestReduceChainForgery._forge_max(pie, settings, np.array([inp[i] for i in pick]))

    return mutate


def _sum_reset(pie, settings):
    t = pie.trace_tables["sum_reduce"]
    inp = t.columns["input"].astype(np.int64)
    acc = np.array([0, inp[0], 0, inp[2]])
    t.columns["acc"] = (acc % P).astype(np.uint32)
    t.columns["next_acc"] = ((acc + inp) % P).astype(np.uint32)
    out = t.columns["out"].copy()
    out[3] = (acc[3] + inp[3]) % P
    t.columns["out"] = out


def _less_than_forgery(pie, settings):
    """Round 5: borrow's coefficient 2^31 - 1 vanishes mod P, so borrow and
    out flip together on every row (0.25 < 0.75 -> 0.0)."""
    t = pie.trace_tables["less_than"]
    t.columns["borrow"] = (1 - t.columns["borrow"]).astype(np.uint32)
    t.columns["out"] = ((1 - t.columns["borrow"].astype(np.int64)) * 4096).astype(np.uint32)


def _mul_forgery(pie, settings):
    """Round 5: the remainder is unbounded, so out + 1000 with rem - 1000 *
    2^12 on one row satisfies the rescale identity."""
    t = pie.trace_tables["mul"]
    out, rem = t.columns["out"].astype(np.int64), t.columns["rem"].astype(np.int64)
    out[0], rem[0] = (out[0] + 1000) % P, (rem[0] - 1000 * 4096) % P
    t.columns["out"], t.columns["rem"] = out.astype(np.uint32), rem.astype(np.uint32)


def _lt_graph(cx, rng):
    (cx.tensor((1, 1)).set([[0.25]]) < cx.tensor((1, 1)).set([[0.75]])).retrieve()


#: name -> (graph, PIE mutation or None, the verdict both must reach).
PIES = {
    **{f"{op}_{col}": (_binary(op), _column(op, col), "rejected")
       for op, col in [("add", "out"), ("mul", "rem"), ("rem", "quotient"), ("less_than", "borrow"),
                       ("less_than", "limb0")]},
    **{f"{op}_{col}": (_unary(op), _column(op, col), "rejected")
       for op, col in [("recip", "rem"), ("sqrt", "rem"), ("sin", "out"), ("exp2", "out"), ("log2", "out")]},
    "sum_reduce_acc": (_reduce("sum_reduce"), _column("sum_reduce", "acc"), "rejected"),
    "max_reduce_is_max": (_reduce("max_reduce"), _column("max_reduce", "is_max"), "rejected"),
    "inputs_val": (_binary("add"), _column("inputs", "val"), "rejected"),
    "contiguous_out": (_contiguous, _column("contiguous", "out"), "rejected"),
    "sin_multiplicity": (_unary("sin"), _multiplicity("sin_lookup"), "rejected"),
    "sin_multiplicity_moved": (_unary("sin"), _multiplicity("sin_lookup", moved=True), "rejected"),
    "range_check_multiplicity": (_binary("less_than"), _multiplicity("range_check_lookup", index=3), "rejected"),
    "forged_smaller_max": (_reduce("max_reduce", [0.1, 0.9, 0.3, 0.2]), _max_chain([0, 0, 2, 2]), "rejected"),
    "max_chain_reset": (_reduce("max_reduce", [0.1, 0.9, 0.3, 0.2]), _max_chain([0, 1, 2, 2]), "rejected"),
    "sum_acc_reset": (_reduce("sum_reduce", [0.1, 0.2, 0.3, 0.4]), _sum_reset, "rejected"),
    "slice_shrink": (_slice_shrink, None, "accepted"),
    "expand_grow": (_expand_grow, None, "accepted"),
    "honest_reduce": (_honest_reduce, None, "accepted"),
    "forgery_less_than_borrow": (_lt_graph, _less_than_forgery, "accepted"),
    "forgery_mul_remainder": (_binary("mul"), _mul_forgery, "accepted"),
}


@pytest.mark.parametrize("name", list(PIES))
def test_mutated_pie_verdicts_match_reference(tmp_path, name):
    """The reference's PIE, mutated, proved by each package (the port reads
    it from the reference's PIE file) and each proof verified by both
    verifiers.  A prover that refuses rejects too; the port's prover runs
    its self-check, the reference's host path does not, so a refusal on
    one side meets a verifier's rejection on the other.  Where both prove,
    the proofs have the same bytes."""
    build, mutate, want = PIES[name]
    cx = R.Graph()
    build(cx, np.random.default_rng(23))
    cx.compile()
    ref_settings = R.gen_circuit_settings(cx)
    ref_pie = R.gen_trace(cx, ref_settings)
    if mutate is not None:
        mutate(ref_pie, ref_settings)
    ref_serde.pie_to_file(ref_pie, str(tmp_path / "pie.npz"))
    pie, settings = serde.pie_from_file(str(tmp_path / "pie.npz")), _port_settings(ref_settings)

    proofs = {}
    for pkg, args in ((R, (ref_pie, ref_settings)), (T, (pie, settings))):
        try:
            proofs[pkg] = pkg.prove(*args, CFG[pkg], **({"device": "cpu"} if pkg is T else {}))
        except (T.LuminairError, R.LuminairError, AssertionError):
            proofs[pkg] = None
    by_verifier = {}
    for whose, proof in proofs.items():
        if proof is None:
            continue
        ref_form = ref_serde.proof_from_payload(serde.proof_to_payload(proof)) if whose is T else proof
        by_verifier[whose] = (_verdict(lambda: R.verify(ref_form, ref_settings)),
                              _verdict(lambda: T.verify(_port_proof(ref_form), settings, device="cpu")))
        assert by_verifier[whose][0] == by_verifier[whose][1], (whose.__name__, by_verifier[whose])
    if proofs[R] is not None and proofs[T] is not None:
        assert serde.proof_to_flat_bytes(proofs[T]) == ref_serde.proof_to_flat_bytes(proofs[R])
    overall = ["accepted" if proofs[pkg] is not None and by_verifier[pkg][0] == "accepted" else "rejected"
               for pkg in (R, T)]
    assert overall == [want, want], by_verifier


# ---------------------------------------------------------------------------
# The verifier's parts against the reference's.


def _tree_and_queries(seed):
    rng = np.random.default_rng(seed)
    logs = [int(l) for l in rng.choice([1, 3, 5, 6], size=6)]
    cols = [rng.integers(0, P, size=1 << l).astype(np.uint32) for l in logs]
    tree = RefMerkleTree(cols)
    queries = {l: np.unique(rng.integers(0, 1 << l, size=3)) for l in set(logs) if rng.random() < 0.8}
    queries.setdefault(max(logs), np.unique(rng.integers(0, 1 << max(logs), size=3)))
    return tree, logs, queries


def _shorten(values):
    values[-1] = values[-1][:-1]


#: A change of the opening -> what both must say of it.
OPENINGS = {
    "honest": lambda root, v, w: (root, v, w),
    "values_missing": lambda root, v, w: (root, v[:-1], w),
    "value_short": lambda root, v, w: (root, v[:-1] + [v[-1][:-1]], w),
    "value_flipped": lambda root, v, w: (root, [x.copy() for x in v[:1]] + v[1:], w),
    "witness_missing": lambda root, v, w: (root, v, w[:-1]),
    "witness_trailing": lambda root, v, w: (root, v, list(w) + [w[0]]),
    "witness_flipped": lambda root, v, w: (root, v, [x.copy() for x in w]),
    "root_flipped": lambda root, v, w: (root.copy(), v, w),
}


@pytest.mark.parametrize("change", list(OPENINGS))
@pytest.mark.parametrize("seed", range(4))
def test_verify_decommitment_matches_reference(seed, change):
    """Random mixed-size trees (host numpy, the reference's MerkleTree),
    opened at random queries per log; each early rejection."""
    tree, logs, queries = _tree_and_queries(seed)
    values, witness = tree.queried_values(queries), tree.decommit(queries)
    root, values, witness = OPENINGS[change](np.asarray(tree.root), list(values), list(witness))
    if change == "value_flipped":
        _flip(values[0])
    elif change == "witness_flipped" and witness:
        _flip(witness[-1])
    elif change == "root_flipped":
        _flip(root)
    want = ref_verify_decommitment(root, logs, queries, values, witness)
    assert verify_decommitment(root, logs, queries, values, witness) == want
    assert want == (change == "honest" or change == "witness_flipped" and not witness)


@pytest.mark.parametrize("kmax", [2, 5, 9, 12])
def test_twiddles_at_positions_match_chain(kmax):
    """The fold twiddles of the queried positions alone equal the
    reference's whole-domain chain (`_twiddle_chain`)."""
    chain = ref_fri._twiddle_chain(kmax)
    rng = np.random.default_rng(kmax)
    for lvl in range(kmax):
        pos = np.unique(rng.integers(0, 1 << lvl, size=9))
        assert np.array_equal(fri.line_twiddles_at(lvl, pos).numpy(), chain[kmax - lvl][pos].astype(np.int64))


def _captured(monkeypatch, case_proof, module, name):
    """Run the reference verifier on a proof and keep the arguments and the
    result of one of its functions."""
    calls = []
    fn = getattr(module, name)

    def keep(*args):
        out = fn(*args)
        calls.append((args, out))
        return out

    monkeypatch.setattr(module, name, keep)
    settings, _, proof = case_proof
    assert R.verify(proof, settings)
    monkeypatch.setattr(module, name, fn)
    return calls[0]


def _port_samples(samples):
    return [ColumnSample(s.commit_log, s.tree, s.col, (f.host_i64(s.point[0]), f.host_i64(s.point[1])), s.value)
            for s in samples]


@pytest.mark.parametrize("case", ["bench8_b1", "bench8_hs2", "all_ops"])
def test_quotients_at_positions_match_reference(cases, monkeypatch, case):
    """The verifier's quotients at the opened positions against the
    reference's `accumulate_quotients(..., domains)` on the same inputs."""
    (samples, opened, gamma, domains), want = _captured(monkeypatch, cases[case][0], ref_scheme,
                                                       "accumulate_quotients")
    got = quotients_at_positions(_port_samples(samples), {k: f.host_i64(v) for k, v in opened.items()}, gamma,
                                 {log: (f.host_i64(xs), f.host_i64(ys)) for log, (xs, ys) in domains.items()})
    assert sorted(got) == sorted(want)
    for log, q in want.items():
        assert np.array_equal(got[log].numpy(), np.asarray(q, dtype=np.int64)), log


@pytest.mark.parametrize("case", ["bench8_b1", "bench8_b3", "bench8_hs1", "all_ops"])
def test_fri_check_queries_matches_reference(cases, monkeypatch, case):
    """The FRI query check on the reference verifier's own inputs (its
    quotients at the positions, its challenges): True for both, and False
    for both with the first layer's challenge changed."""
    args, want = _captured(monkeypatch, cases[case][0], ref_scheme.fri_mod, "fri_check_queries")
    ref_proof, config, alpha0, alphas, query_eval, input_logs, positions = args
    port_fri = _port_proof(cases[case][0][2]).pcs_proof.fri_proof
    port_config = PcsConfig.from_dict(cases[case][0][2].config.to_dict()).fri
    assert want is True
    assert fri.fri_check_queries(port_fri, port_config, alpha0, alphas, query_eval, input_logs, positions) is True
    bent = [np.asarray((a + np.array([1, 0, 0, 0])) % P, dtype=np.uint32) if i == 0 else a
            for i, a in enumerate(alphas)]
    assert ref_fri.fri_check_queries(ref_proof, config, alpha0, bent, query_eval, input_logs, positions) is False
    assert fri.fri_check_queries(port_fri, port_config, alpha0, bent, query_eval, input_logs, positions) is False


@pytest.mark.parametrize("case", ["bench8_b1", "bench8_hs2", "pinn"])
def test_fri_verify_replays_and_checks(cases, monkeypatch, case):
    """`fri_verify` (replay, then the query check) on the channel and the
    quotients of the port verifier's own run: True; with a FRI layer root
    flipped the replay draws other challenges and the check fails."""
    settings, _, proof = cases[case][1]
    seen = {}
    replay, check = fri.fri_replay, fri.fri_check_queries

    def keep_replay(p, config, channel, input_logs):
        seen["replay"] = (copy.deepcopy(channel), input_logs)
        return replay(p, config, channel, input_logs)

    def keep_check(*args):
        seen["check"] = args
        return check(*args)

    monkeypatch.setattr(fri, "fri_replay", keep_replay)
    monkeypatch.setattr(fri, "fri_check_queries", keep_check)
    assert T.verify(proof, settings, device="cpu", **_security(case, T))
    monkeypatch.undo()
    channel, input_logs = seen["replay"]
    query_eval, positions = seen["check"][4], seen["check"][6]
    config = proof.config.fri
    assert fri.fri_verify(proof.pcs_proof.fri_proof, config, copy.deepcopy(channel), query_eval, input_logs, positions)
    bad = copy.deepcopy(proof.pcs_proof.fri_proof)
    bad.layer_roots[0] = bad.layer_roots[0].copy()
    _flip(bad.layer_roots[0])
    assert not fri.fri_verify(bad, config, channel, query_eval, input_logs, positions)


@pytest.mark.parametrize("log", [0, 1, 4, 7])
def test_line_eval_at_x_matches_reference(log):
    rng = np.random.default_rng(log)
    coeffs = rng.integers(0, P, size=(1 << log, 4)).astype(np.uint32)
    xs = rng.integers(0, P, size=6).astype(np.uint32)
    got = fft.line_eval_at_x(coeffs, xs)
    for x, g in zip(xs, got):
        assert np.array_equal(g.numpy(), np.asarray(ref_line_eval_at_x(coeffs, x), dtype=np.int64))


def test_lut_validation_matches_reference():
    """The reference's own cases (test_lut_normative.py): ulp noise passes,
    cos labelled sin fails, a short table fails; (ok, n_bad) equal."""
    layout = preprocessed.LookupLayout([preprocessed.Range(-163840, 184320)])
    vals = layout.all_values()[:4096]
    outs = preprocessed.lut_reference_outputs("exp2", vals)
    noisy = outs + np.random.default_rng(5).integers(-1, 2, size=len(outs))
    wide = preprocessed.LookupLayout([preprocessed.Range(-4096, 4096)]).all_values()
    from luminair_tpu_torch import fixed

    cos = fixed.from_float(np.cos(fixed.to_float(wide)))
    for kind, v, o, ok in (("exp2", vals, noisy, True), ("sin", wide, cos, False), ("exp2", vals, outs[:-1], False)):
        got = preprocessed.validate_lut_outputs(kind, v, o)
        assert got == ref_pp.validate_lut_outputs(kind, v, o)
        assert got[0] is ok


def test_query_side_calls_no_twin(cases, monkeypatch):
    """With the preprocessed root cached, a verify runs no kernel wrapper's
    plain twin: the query-side checks are the verifier's own host code."""
    settings, _, proof = cases["all_ops"][1]
    assert T.verify(proof, settings, device="cpu")  # the recommit fills the cache

    def guard(mod, name):
        def refuse(*args, **kwargs):
            raise AssertionError(f"the verifier called {name}")

        monkeypatch.setattr(mod, name, refuse)

    for mod in (kernels, tape, blake2s):
        for name in [n for n in dir(mod) if n.endswith("_plain")]:
            guard(mod, name)
    for name in ("circle_ifft", "circle_fft", "circle_lde", "merkle_tree", "fri_layer", "deep_quotient_many",
                 "oods_eval_many", "decommit", "channel_draw_felt", "grind_pow"):
        guard(kernels, name)
    assert T.verify(proof, settings, device="cpu")


def test_preprocessed_root_cache(cases):
    """The recommit's root is the proof's tree-0 root; the cache holds it
    per (settings bytes, preprocessed logs, blowup) and stays at most 16."""
    settings, _, proof = cases["pinn"][1]
    verifier._PP_ROOT_CACHE.clear()
    assert T.verify(proof, settings, device="cpu")
    assert [np.asarray(r).tolist() for r in verifier._PP_ROOT_CACHE.values()] == [proof.roots[0].tolist()]
    for name in CASES:
        s, _, p = cases[name][1]
        assert T.verify(p, s, device="cpu", **_security(name, T))
    assert 0 < len(verifier._PP_ROOT_CACHE) <= 16
