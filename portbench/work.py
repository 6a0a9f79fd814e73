"""The least work a request's statement asks of the card, and the one rate
table every roofline divides by.

Rates (NVIDIA H100 SXM data sheet, 700 W): 3.35 TB/s of HBM3; 33.5 T
32-bit integer operations a second, the issue ceiling of the ALU and FMA
pipes together (132 SMs x 128 lanes x 1.98 GHz), above every rate the
field arithmetic reaches.  Operation counts per field operation: a
product 6 (the 32x32->64 product, the Mersenne fold's and, shift and
add, a compare-select), a sum or difference 3; a Blake2s compression
968 (10 rounds x 8 G x 12, one LOP3 a word of output).

Each count is a function of the statement alone (tables, columns, the
PCS profile) and counts the least: every input word read once, every
output word written once, and the fewest butterflies or compressions
the transform needs.
"""

from __future__ import annotations

from dataclasses import dataclass

from .statement import Pcs, Statement

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 33.5e12
OPS_MUL = 6
OPS_ADD = 3
OPS_BUTTERFLY = OPS_MUL + 2 * OPS_ADD
OPS_BLAKE2S_BLOCK = 80 * 12 + 8


@dataclass
class Work:
    n_bytes: float = 0.0
    n_ops: float = 0.0

    def __add__(self, other: "Work") -> "Work":
        return Work(self.n_bytes + other.n_bytes, self.n_ops + other.n_ops)

    @property
    def seconds(self) -> float:
        """The least time: bytes at HBM bandwidth or operations at the
        integer rate, whichever is longer."""
        return max(self.n_bytes / HBM_BYTES_PER_S, self.n_ops / INT32_OPS_PER_S)


def lde(log: int, cols: int, B: int) -> Work:
    """Commit-side circle transforms of `cols` columns of 2^log values:
    interpolation (log stages of 2^(log-1) butterflies, a scaling product
    a word; values read, coefficients written) and evaluation on the
    2^B times larger domain (2^B cosets of log stages; coefficients read,
    evaluations written)."""
    n = 1 << log
    inverse = Work(8 * n, log * (n // 2) * OPS_BUTTERFLY + n * OPS_MUL)
    forward = Work(4 * n + 4 * (n << B), (1 << B) * log * (n // 2) * OPS_BUTTERFLY)
    one = inverse + forward
    return Work(cols * one.n_bytes, cols * one.n_ops)


def merkle(cols_by_log: dict) -> Work:
    """A Blake2s Merkle tree over columns of mixed sizes: its columns read
    once, its 2^(b+1) - 1 digests written once; a node of layer l hashes
    its children's 16 words (none on the leaf layer) and the words of the
    columns of log l, ceil(words / 16) compressions."""
    bottom = max(cols_by_log)
    n_bytes = sum(4 * c * (1 << log) for log, c in cols_by_log.items()) + 32 * ((2 << bottom) - 1)
    blocks = 0
    for log in range(bottom + 1):
        words = (16 if log < bottom else 0) + cols_by_log.get(log, 0)
        blocks += (1 << log) * -(-words // 16)
    return Work(n_bytes, blocks * OPS_BLAKE2S_BLOCK)


def request(st: Statement, pcs: Pcs) -> dict:
    """{part: Work} of one request: the trace's columns written once, the
    four trees' transforms (`lde`) and hashing with the FRI layers' trees
    (`merkle`)."""
    B = pcs.log_blowup
    trees = st.trees(B)
    out = {"trace": Work(4 * st.cells, 0), "lde": Work(), "merkle": Work()}
    for tree in trees:
        for log, cols in tree.items():
            out["lde"] += lde(log, cols, B)
        out["merkle"] += merkle({log + B: cols for log, cols in tree.items()})
    for log in st.fri_layers(pcs):
        out["merkle"] += merkle({log: 4})
    return out


def total(parts: dict) -> Work:
    """The whole request's work, summed before the bound is taken: the
    least time of the parts together."""
    acc = Work()
    for w in parts.values():
        acc += w
    return acc
