"""The head of a proof's flat wire bytes (magic ``LMVF``, version, the PCS
profile, the claim), read to judge it against the statement."""

from __future__ import annotations

import struct
from typing import Dict, Tuple


def header(data: bytes) -> Tuple[dict, Dict[int, int]]:
    """({pow_bits, log_blowup, log_last_layer_degree_bound, n_queries,
    folds_per_layer}, {component index: log size}); ValueError on bytes
    that are not a proof."""
    if len(data) < 32 or data[:4] != b"LMVF":
        raise ValueError("not a flat proof")
    version, pow_bits, blowup, last, queries, folds, n = struct.unpack_from("<7I", data, 4)
    if version != 2 or n > 64 or len(data) < 32 + 8 * n:
        raise ValueError(f"unreadable proof head (version {version}, {n} components)")
    pairs = struct.unpack_from(f"<{2 * n}I", data, 32)
    config = dict(pow_bits=pow_bits, log_blowup=blowup, log_last_layer_degree_bound=last,
                  n_queries=queries, folds_per_layer=folds)
    return config, dict(zip(pairs[0::2], pairs[1::2]))
