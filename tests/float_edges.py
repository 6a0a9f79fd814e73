"""Float inputs at the edges of the fixed encoding (fixed.from_float: x * 2^12
rounded half to even, NaN to 0, saturated at +-2^62), by case; shared by the
CPU tests of the encode item's twin and its kernel's rows and by the card's."""

import numpy as np

_K = np.concatenate([np.arange(-9, 9), [2**20, -(2**20) - 1, 2**40 + 1, -(2**40) - 3]]).astype(np.float64)
_SUB = np.array([5e-324, 1e-310, 2.2250738585072009e-308, 2.2250738585072014e-308])
_CLIP = np.array([2.0**50 - 1, 2.0**50, 2.0**51, np.nextafter(2.0**50, 0), np.nextafter(2.0**50, 4.0**50),
                  2.0**50 - 0.5 / 4096, 1e300, np.finfo(np.float64).max])


def _nans() -> np.ndarray:
    """NaNs of both signs, quiet and signalling, with payloads; infinities."""
    bits = np.array([0x7FF8000000000000, 0xFFF8000000000000, 0x7FF0000000000001, 0xFFF0000000000001,
                     0x7FFFFFFFFFFFFFFF, 0x7FF4000000000123], dtype=np.uint64)
    return np.concatenate([bits.view(np.float64), [np.inf, -np.inf, np.nan]])


EDGE_CASES = {
    "ties": np.concatenate([(_K + 0.5) / 4096, (_K - 0.5) / 4096]),
    "zeros_subnormals": np.concatenate([[0.0, -0.0], _SUB, -_SUB]),
    "nan_inf": _nans(),
    "clip": np.concatenate([_CLIP, -_CLIP]),
    "float32": np.random.default_rng(11).normal(0, 100, 256).astype(np.float32).astype(np.float64),
    "normal": np.random.default_rng(12).normal(0, 1, 1 << 12),
}


def edge_floats() -> np.ndarray:
    """Every case's values but the 2^12 normal draw, in one float64 array."""
    return np.concatenate([v for k, v in EDGE_CASES.items() if k != "normal"])
