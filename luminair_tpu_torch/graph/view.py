"""View: strided tensor views with broadcast + validity masks.

The equivalent of luminal's ShapeTracker (symbolic index/validity
expressions, fake dims).  A View resolves the whole logical index space
to (physical_index, valid) arrays in one vectorized gather.

A View over a physical buffer of `buffer_len` elements:
  * sizes[i]   logical dimension sizes
  * strides[i] physical strides (0 = broadcast "fake" dim)
  * base       physical offset
  * valid[i]   (lo, hi): logical coords outside [lo, hi) read as 0
               (introduced by padding)

Movement ops return new Views: permute / expand / slice / pad / reshape
(reshape only on contiguous views -- the frontend inserts a Contiguous op
otherwise, matching luminal's semantics).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import List, Tuple

import numpy as np


def contiguous_strides(sizes) -> List[int]:
    st = [0] * len(sizes)
    acc = 1
    for i in range(len(sizes) - 1, -1, -1):
        st[i] = acc
        acc *= sizes[i]
    return st


@dataclass(frozen=True)
class View:
    sizes: Tuple[int, ...]
    strides: Tuple[int, ...]
    base: int
    valid: Tuple[Tuple[int, int], ...]
    buffer_len: int

    # -- constructors -----------------------------------------------------

    @staticmethod
    def contiguous(shape) -> "View":
        shape = tuple(int(s) for s in shape)
        n = int(np.prod(shape)) if shape else 1
        return View(
            sizes=shape,
            strides=tuple(contiguous_strides(shape)),
            base=0,
            valid=tuple((0, s) for s in shape),
            buffer_len=n,
        )

    # -- properties -------------------------------------------------------

    @property
    def shape(self):
        return self.sizes

    @property
    def n_elements(self) -> int:
        return int(np.prod(self.sizes)) if self.sizes else 1

    def is_contiguous(self) -> bool:
        return (
            self.base == 0
            and self.strides == tuple(contiguous_strides(self.sizes))
            and all(v == (0, s) for v, s in zip(self.valid, self.sizes))
            and self.n_elements == self.buffer_len
        )

    def has_mask(self) -> bool:
        return any(v != (0, s) for v, s in zip(self.valid, self.sizes))

    def is_mult_uniform(self) -> bool:
        """True when every physical buffer element is read the same number
        of times by a full logical traversal (permute/broadcast of the
        whole buffer).  Compute ops require this for LogUp balance; the
        frontend inserts Contiguous otherwise."""
        if self.base != 0 or self.has_mask():
            return False
        real = sorted(
            ((st, sz) for st, sz in zip(self.strides, self.sizes) if st != 0 and sz > 1),
            key=lambda p: -p[0],
        )
        expect = 1
        for st, sz in reversed(real):
            if st != expect:
                return False
            expect *= sz
        return expect == self.buffer_len

    def expansion_factor(self) -> int:
        """Product of broadcast (stride-0) dim sizes: how many times each
        physical element is read (reference graph.rs:220-243)."""
        f = 1
        for st, sz in zip(self.strides, self.sizes):
            if st == 0:
                f *= sz
        return f

    # -- movement ops -----------------------------------------------------

    def permute(self, order) -> "View":
        order = tuple(order)
        assert sorted(order) == list(range(len(self.sizes)))
        return replace(
            self,
            sizes=tuple(self.sizes[i] for i in order),
            strides=tuple(self.strides[i] for i in order),
            valid=tuple(self.valid[i] for i in order),
        )

    def broadcast(self, dim: int, size: int) -> "View":
        """Broadcast an EXISTING dim at `dim` to `size`.

        The dim must already have the target size (no-op) or size 1.  Unlike
        `expand`, `broadcast(dim, 1)` on a size-1 dim is a well-defined no-op
        -- the ambiguity that made matmul produce (m, 1, 1) outputs when
        out-features == 1 (luminal's expand conflated both behaviours)."""
        assert 0 <= dim < len(self.sizes), f"broadcast dim {dim} out of range for {self.sizes}"
        if self.sizes[dim] == size:
            return self
        assert self.sizes[dim] == 1, f"cannot broadcast dim {dim} of {self.sizes} to {size}"
        sizes = list(self.sizes)
        sizes[dim] = size
        strides = list(self.strides)
        strides[dim] = 0
        valid = list(self.valid)
        valid[dim] = (0, size)
        return replace(self, sizes=tuple(sizes), strides=tuple(strides), valid=tuple(valid))

    def insert(self, dim: int, size: int) -> "View":
        """Insert a NEW stride-0 (broadcast) dim of `size` at position `dim`."""
        assert 0 <= dim <= len(self.sizes), f"insert dim {dim} out of range for {self.sizes}"
        sizes = list(self.sizes)
        strides = list(self.strides)
        valid = list(self.valid)
        sizes.insert(dim, size)
        strides.insert(dim, 0)
        valid.insert(dim, (0, size))
        return replace(self, sizes=tuple(sizes), strides=tuple(strides), valid=tuple(valid))

    def expand(self, dim: int, size: int) -> "View":
        """Legacy luminal-style expand: broadcast an existing size-1 dim when
        `size != 1`, otherwise insert a new broadcast dim.  Ambiguous when the
        target size is 1 -- new code should call `broadcast` or `insert`."""
        if dim < len(self.sizes) and self.sizes[dim] == 1 and size != 1:
            return self.broadcast(dim, size)
        return self.insert(dim, size)

    def reshape(self, shape) -> "View":
        shape = tuple(int(s) for s in shape)
        assert int(np.prod(shape)) == self.n_elements, "reshape size mismatch"
        assert self.is_contiguous(), "reshape requires a contiguous view"
        return View.contiguous(shape)

    def slice(self, dim: int, start: int, end: int) -> "View":
        assert 0 <= start <= end <= self.sizes[dim]
        sizes = list(self.sizes)
        valid = list(self.valid)
        lo, hi = valid[dim]
        sizes[dim] = end - start
        valid[dim] = (max(lo - start, 0), min(hi - start, end - start))
        return replace(
            self,
            sizes=tuple(sizes),
            valid=tuple(valid),
            base=self.base + start * self.strides[dim],
        )

    def pad(self, dim: int, left: int, right: int) -> "View":
        sizes = list(self.sizes)
        valid = list(self.valid)
        lo, hi = valid[dim]
        sizes[dim] = left + sizes[dim] + right
        valid[dim] = (lo + left, hi + left)
        return replace(
            self,
            sizes=tuple(sizes),
            valid=tuple(valid),
            base=self.base - left * self.strides[dim],
        )

    # -- resolution -------------------------------------------------------

    def gather(self, buffer):
        """Read the full logical index space from a physical buffer: an
        (n_elements,) array; invalid (padded) positions are 0."""
        phys, valid = self.indices()
        vals = buffer[np.clip(phys, 0, len(buffer) - 1)]
        return np.where(valid, vals, np.zeros_like(vals))

    def indices(self):
        """(physical_index, valid) arrays over the logical index space."""
        n = self.n_elements
        idx = np.arange(n, dtype=np.int64)
        phys = np.full(n, self.base, dtype=np.int64)
        valid = np.ones(n, dtype=bool)
        # per-dim coordinates, most-significant first (C order)
        coords = []
        for i, size in enumerate(self.sizes):
            inner = 1
            for s in self.sizes[i + 1 :]:
                inner *= s
            coords.append((idx // inner) % max(size, 1))
        for c, stride, (lo, hi) in zip(coords, self.strides, self.valid):
            phys = phys + c * stride
            valid &= (c >= lo) & (c < hi)
        return phys, valid
