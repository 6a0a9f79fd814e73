"""FRI folds, FRI commitment and DEEP quotients of luminair_tpu_torch against
luminair_tpu.pcs."""

import numpy as np
import pytest

from luminair_tpu import circle as ref_circle
from luminair_tpu.crypto.channel import Blake2sChannel as RefChannel
from luminair_tpu.pcs import fri as ref_fri
from luminair_tpu.pcs import quotients as ref_q
from luminair_tpu.pcs.config import FriConfig as RefFriConfig
from luminair_tpu_torch import circle
from luminair_tpu_torch import fields as f
from luminair_tpu_torch.crypto.channel import Blake2sChannel
from luminair_tpu_torch.pcs import fri
from luminair_tpu_torch.pcs import quotients as q
from luminair_tpu_torch.pcs.config import FriConfig

P = (1 << 31) - 1


def _qm31(seed, n):
    rng = np.random.default_rng(seed)
    return rng.integers(0, P, size=(n, 4), dtype=np.int64).astype(np.uint32)


def _eq(port, ref):
    assert np.array_equal(f.tensor_to_u32(port), np.asarray(ref, dtype=np.uint32))


@pytest.mark.parametrize("log", [1, 3, 8])
def test_fold_circle_to_line(log):
    v = _qm31(log, 1 << log)
    alpha = _qm31(50 + log, 1)[0]
    _eq(fri.fold_circle_to_line(f.u32_to_tensor(v), log, alpha), ref_fri.fold_circle_to_line(v, log, alpha))


@pytest.mark.parametrize("kmax,line_log", [(4, 3), (9, 8), (9, 5), (9, 1)])
@pytest.mark.parametrize("with_mix", [False, True])
def test_fold_line(kmax, line_log, with_mix):
    v = _qm31(kmax * 10 + line_log, 1 << line_log)
    alpha = _qm31(7, 1)[0]
    t_inv = ref_circle.ifft_twiddles(kmax)[kmax - line_log]
    ref = ref_fri.fold_line(v, t_inv, alpha)
    mix = beta2 = None
    if with_mix:
        from luminair_tpu.fields import qm31 as ref_qm31

        mix = _qm31(8, 1 << (line_log - 1))
        beta2 = ref_qm31.mul(alpha, alpha)
        ref = ref_qm31.add(ref, ref_qm31.mul(np.broadcast_to(beta2, ref.shape), mix))
        mix = f.u32_to_tensor(mix)
    alpha_t = f.u32_to_tensor(alpha, dtype=f.I64)
    beta2_t = f.u32_to_tensor(beta2, dtype=f.I64) if with_mix else None
    _eq(fri.fold_line(f.u32_to_tensor(v), kmax, line_log, alpha_t, mix, beta2_t), ref)


def _sample_setup(seed, logs_and_points):
    """Columns on commit domains and samples at random QM31 points."""
    rng = np.random.default_rng(seed)
    pts = {}
    ref_samples, port_samples, ref_cols, port_cols = [], [], {}, {}
    for i, (log, pkey) in enumerate(logs_and_points):
        if pkey not in pts:
            t = rng.integers(0, P, size=4, dtype=np.int64).astype(np.uint32)
            pts[pkey] = (ref_circle.point_from_t_qm31(t), circle.point_from_t_qm31(f.u32_to_tensor(t, dtype=f.I64)))
        ref_pt, port_pt = pts[pkey]
        col = rng.integers(0, P, size=1 << log, dtype=np.int64).astype(np.uint32)
        value = rng.integers(0, P, size=4, dtype=np.int64).astype(np.uint32)
        ref_samples.append(ref_q.ColumnSample(log, 0, i, ref_pt, value))
        port_samples.append(q.ColumnSample(log, 0, i, port_pt, value))
        ref_cols[(0, i)] = col
        port_cols[(0, i)] = f.u32_to_tensor(col)
    return ref_samples, port_samples, ref_cols, port_cols


@pytest.mark.parametrize(
    "layout",
    [
        [(5, "z")],
        [(6, "z"), (6, "z"), (6, "w"), (4, "z"), (4, "v"), (6, "z")],
        [(3, "a"), (7, "b"), (7, "a"), (3, "a")],
    ],
)
def test_accumulate_quotients(layout):
    ref_samples, port_samples, ref_cols, port_cols = _sample_setup(len(layout), layout)
    gamma = _qm31(99, 1)[0]
    ref = ref_q.accumulate_quotients(ref_samples, ref_cols, gamma)
    port = q.accumulate_quotients(port_samples, port_cols, f.u32_to_tensor(gamma, dtype=f.I64))
    assert sorted(ref) == sorted(port)
    for log in ref:
        _eq(port[log], ref[log])


@pytest.mark.parametrize("folds_per_layer", [1, 2, 3])
def test_fri_prove_and_decommit(folds_per_layer):
    """Two inputs (logs 9 and 8) of low degree; roots, last layer, channel
    state and openings equal the reference's."""
    from luminair_tpu import fft as ref_fft

    rng = np.random.default_rng(folds_per_layer)
    inputs = {}
    for log in (9, 8):
        coeffs = np.zeros((4, 1 << log), dtype=np.uint32)
        coeffs[:, ::2] = rng.integers(0, P, size=(4, 1 << (log - 1)), dtype=np.int64).astype(np.uint32)
        inputs[log] = np.ascontiguousarray(ref_fft.fft(coeffs).T)
    ref_cfg = RefFriConfig(log_last_layer_degree_bound=2, n_queries=5, folds_per_layer=folds_per_layer)
    cfg = FriConfig(log_last_layer_degree_bound=2, n_queries=5, folds_per_layer=folds_per_layer)
    ref_ch, ch = RefChannel(), Blake2sChannel()
    ref_proof, ref_ctx = ref_fri.fri_prove(inputs, ref_cfg, ref_ch)
    proof, ctx = fri.fri_prove({k: f.u32_to_tensor(v) for k, v in inputs.items()}, cfg, ch)
    assert ch.digest == ref_ch.digest
    assert len(proof.layer_roots) == len(ref_proof.layer_roots)
    for a, b in zip(proof.layer_roots, ref_proof.layer_roots):
        assert np.array_equal(a, b)
    assert np.array_equal(proof.last_layer_coeffs, ref_proof.last_layer_coeffs)
    positions = ref_ch.draw_queries(5, 9)
    assert np.array_equal(positions, ch.draw_queries(5, 9))
    ref_fri.fri_decommit(ref_proof, ref_ctx, positions)
    fri.fri_decommit(proof, ctx, positions)
    for port_layer, ref_layer in zip(proof.layer_queried_values + proof.layer_witnesses,
                                     ref_proof.layer_queried_values + ref_proof.layer_witnesses):
        assert len(port_layer) == len(ref_layer)
        for a, b in zip(port_layer, ref_layer):
            assert np.array_equal(a, b)
    assert fri.needed_input_positions(positions, [9, 8], cfg) == ref_fri.needed_input_positions(
        positions, [9, 8], ref_cfg
    )
