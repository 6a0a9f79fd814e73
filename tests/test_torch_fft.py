"""luminair_tpu_torch.fft against luminair_tpu.fft, element for element."""

import numpy as np
import pytest

from luminair_tpu import circle as ref_circle
from luminair_tpu import fft as ref_fft
from luminair_tpu_torch import circle, fft
from luminair_tpu_torch import fields as f

P = (1 << 31) - 1


def _cols(seed, batch, log):
    rng = np.random.default_rng(seed)
    return rng.integers(0, P, size=(batch, 1 << log), dtype=np.int64).astype(np.uint32)


def _eq(port, ref):
    assert np.array_equal(f.tensor_to_u32(port), np.asarray(ref, dtype=np.uint32))


@pytest.mark.parametrize("log", range(1, 13))
def test_ifft_fft(log):
    a = _cols(log, 3, log)
    _eq(fft.ifft(f.u32_to_tensor(a)), ref_fft.ifft(a))
    _eq(fft.fft(f.u32_to_tensor(a)), ref_fft.fft(a))


@pytest.mark.parametrize("log_blowup", [1, 2, 3, 4])
@pytest.mark.parametrize("log", [1, 2, 5, 8])
def test_lde(log, log_blowup):
    a = _cols(100 + log, 2, log)
    _eq(fft.lde(f.u32_to_tensor(a), log_blowup), ref_fft.lde(a, log_blowup))


def test_fft_m_start_and_batch_axes():
    a = _cols(7, 4, 6)
    dup = np.stack([a, a], axis=-1).reshape(4, -1)
    _eq(fft.fft(f.u32_to_tensor(dup), m_start=4), ref_fft.fft(dup, m_start=4))
    _eq(fft.ifft(f.u32_to_tensor(a.reshape(2, 2, -1))), ref_fft.ifft(a.reshape(2, 2, -1)))


def _point(seed):
    rng = np.random.default_rng(seed)
    t = rng.integers(0, P, size=4, dtype=np.int64).astype(np.uint32)
    return ref_circle.point_from_t_qm31(t), circle.point_from_t_qm31(f.u32_to_tensor(t, dtype=f.I64))


@pytest.mark.parametrize("log", [0, 1, 4, 9])
def test_eval_at_point(log):
    ref_pt, pt = _point(log)
    _eq(pt[0], ref_pt[0])
    _eq(pt[1], ref_pt[1])
    c = _cols(200 + log, 5, log)
    _eq(fft.eval_at_point_many([(f.u32_to_tensor(c), pt)]), ref_fft.eval_at_point_many(c, ref_pt))
    # One column against the reference's single-column evaluator.
    _eq(fft.eval_at_point_many([(f.u32_to_tensor(c[:1]), pt)]), ref_fft.eval_at_point(c[:1], ref_pt))


@pytest.mark.parametrize("log", [1, 3, 6])
def test_line_ifft_qm31(log):
    rng = np.random.default_rng(log)
    v = rng.integers(0, P, size=(1 << log, 4), dtype=np.int64).astype(np.uint32)
    kmax = log + 2
    ref_tw = ref_circle.ifft_twiddles(kmax)[kmax - log :]
    tw = circle.ifft_twiddles(kmax)[kmax - log :]
    _eq(fft.line_ifft_qm31(f.u32_to_tensor(v, dtype=f.I64), tw), ref_fft.line_ifft_qm31(v, ref_tw))


@pytest.mark.parametrize("log", [1, 4, 10])
def test_domain_and_twiddles(log):
    xs, ys = circle.domain_points(log)
    rx, ry = ref_circle.domain_points(log)
    _eq(xs, rx)
    _eq(ys, ry)
    for port, ref in zip(circle.ifft_twiddles(log), ref_circle.ifft_twiddles(log)):
        _eq(port, ref)
