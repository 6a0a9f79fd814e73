"""Trace generation on a torch device: the graph interpreter with every
trace column born on the device, already padded.

The host interpreter (trace.py ``_run``) is the spec; this module replays
the same per-op logic through the trace kernels (kernels.trace_binary /
trace_unary / trace_reduce / lut_minmax, csrc/trace.cu), one launch per
node.  The host walks the graph once: it fixes each table's row offsets
(blocks in toposort order, as the host appends them), the op counter and
each node's yield multiplicity, allocates each table's columns at their
padded size with the padding rows filled, and uploads the fixed-encoded
inputs, constants and LUT tables in one copy.  Each kernel then writes its
node's rows in place.  The only downloads are the range flags and the
retrieved outputs, together, at the end; the PIE's columns stay where they
were written and prove() reads them there.  On CPU tensors the kernels'
plain twins do the same work.

The settings pre-pass cannot read LUT outputs (the LUTs do not exist yet),
so at each sin/exp2/log2 node it downloads the node's gathered input and
the min / max of the raw source buffer (T4), applies f on the host in
float64 exactly as the host pre-pass does (the device's sin and exp2 are
not numpy's), and uploads the result as the node's output.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, List

import numpy as np
import torch

from .. import fields as f
from .. import fixed
from .. import kernels
from ..air.pie import ExecutionResources, LuminairPie, Metadata, TraceTable, padding_value
from ..air.preprocessed import LUT_FNS, calculate_log_size, lut_reference_outputs
from ..air.settings import CircuitSettings
from ..errors import LuminairError
from .graph import Graph
from .trace import lut_range, settings_from_ranges
from .view import View

_LUT_OPS = ("sin", "exp2", "log2")
_BINARY = ("add", "mul", "rem", "less_than")
_UNARY = ("recip", "square", "sqrt", "sin", "exp2", "log2", "contiguous")
_REDUCE = ("sum_reduce", "max_reduce")
#: The ops the device interpreter runs; any other op raises.
DEVICE_OPS = frozenset(_BINARY + _UNARY + _REDUCE + ("copy_to", "copy_from", "constant", "function"))
#: The flag words the kernels set: an input outside a LUT's ranges, a
#: max_reduce step outside [0, 2^30).
_FLAGS = _LUT_OPS + ("max_reduce",)
_P = (1 << 31) - 1

_IDS = "node_id idx is_last_idx next_node_id next_idx".split()
_MULTS = ["lhs_mult", "rhs_mult", "out_mult"]
_BIN = _IDS + "lhs_id next_lhs_id rhs_id next_rhs_id lhs rhs".split()
_UN = _IDS + "input_id next_input_id input out".split()
_RED = "node_id input_id idx is_last_idx next_node_id next_input_id next_idx input out".split()
_LUT_COLS = _UN + ["lookup_mult", "input_mult", "out_mult"]

#: Each table's columns in the order the host interpreter writes them.
TABLE_COLUMNS = {
    "inputs": _IDS + ["val", "multiplicity"],
    "add": _BIN + ["out"] + _MULTS,
    "mul": _BIN + ["out", "rem"] + _MULTS,
    "rem": _BIN + ["rem", "quotient"] + _MULTS,
    "less_than": _BIN + "out borrow diff limb0 limb1 limb2 limb3".split() + _MULTS + ["range_check_mult"],
    "recip": _UN + ["rem", "scale", "input_mult", "out_mult"],
    "sqrt": _UN + ["rem", "scale", "input_mult", "out_mult"],
    "square": _UN + ["rem", "input_mult", "out_mult"],
    "sin": _LUT_COLS,
    "exp2": _LUT_COLS,
    "log2": _LUT_COLS,
    "contiguous": _UN + ["input_mult", "out_mult"],
    "sum_reduce": _RED + ["acc", "next_acc", "is_last_step", "input_mult", "out_mult"],
    "max_reduce": _RED + "max_val next_max_val is_max ge_limb0 ge_limb1 ge_limb2 ge_limb3 range_check_mult "
                         "is_last_step input_mult out_mult".split(),
}


@dataclass
class _Block:
    nid: int
    table: str
    offset: int  # first row of the node in its table
    rows: int


class _Plan:
    """The host's one walk of the graph."""

    def __init__(self, graph: Graph):
        self.graph = graph
        self.order = graph.toposort()
        self.blocks: List[_Block] = []
        self.table_rows: Dict[str, int] = {}  # tables in the order of their first block
        self.op_counter: Dict[str, int] = defaultdict(int)
        self.last_use: Dict[int, int] = {}
        for pos, nid in enumerate(self.order):
            node = graph.nodes[nid]
            if node.op not in DEVICE_OPS:
                raise LuminairError(f"op {node.op} has no trace kernel")
            for s, _ in node.srcs:
                self.last_use[s] = pos
            if node.op in ("function", "copy_from"):
                continue
            table = "inputs" if node.op in ("copy_to", "constant") else node.op
            rows = self.rows(node)
            self.blocks.append(_Block(nid, table, self.table_rows.get(table, 0), rows))
            self.table_rows[table] = self.table_rows.get(table, 0) + rows
            self.op_counter[table] += 1
        # Yield multiplicities: expansion-weighted in-proof consumer edges
        # (Graph.expansion_adjusted_consumers, for every node in one pass).
        adj: Dict[int, int] = defaultdict(int)
        for node in graph.nodes:
            if node.op != "copy_from":
                for s, v in node.srcs:
                    adj[s] += v.expansion_factor()
        self.out_mult = {nid: adj[nid] % _P for nid in self.order}
        consumed = graph.consumers()
        self.input_ids = [n.id for n in graph.nodes if n.op == "function" and consumed[n.id] > 0]
        self.keep = set(graph.to_retrieve)

    def rows(self, node) -> int:
        """The rows a node writes in its table."""
        if node.op == "copy_to":
            return self.graph.nodes[node.srcs[0][0]].out_len
        if node.op == "constant":
            return 1
        src, view = node.srcs[0]
        if node.op == "contiguous":
            return max(self.graph.nodes[src].out_len, view.n_elements)
        return view.n_elements

    def upload(self, dev: torch.device, luts: Dict[str, np.ndarray]):
        """One host-to-device copy of the fixed-encoded inputs and
        constants, and of each LUT's packed (lo, hi, start, outputs).
        Returns ({node id: int64 buffer}, {kind: (lo, hi, start, outputs)})."""
        g = self.graph
        parts, keys = [], []
        for nid in self.input_ids:
            parts.append(fixed.from_float(g.input_data.get(nid, np.zeros(g.nodes[nid].out_len, dtype=np.float64))))
            keys.append(("node", nid))
        for nid in self.order:
            if g.nodes[nid].op == "constant":
                parts.append(fixed.from_float(np.array([g.nodes[nid].params["value"]])))
                keys.append(("node", nid))
        for kind, arrays in luts.items():
            for k, a in enumerate(arrays):
                parts.append(np.asarray(a, dtype=np.int64))
                keys.append((kind, k))
        flat = torch.from_numpy(np.concatenate(parts) if parts else np.zeros(0, np.int64)).to(dev)
        nodes, tables, at = {}, defaultdict(list), 0
        for (what, k), a in zip(keys, parts):
            piece = flat[at : at + len(a)]
            at += len(a)
            if what == "node":
                nodes[k] = piece
            else:
                tables[what].append(piece)
        return nodes, {k: tuple(v) for k, v in tables.items()}


def _reduce_dims(node):
    sh = node.srcs[0][1].shape
    dim = node.params["dim"]
    return int(np.prod(sh[:dim])) if dim > 0 else 1, sh[dim], int(np.prod(sh[dim + 1 :])) if dim + 1 < len(sh) else 1


def _step(plan: _Plan, node, buffers) -> kernels.TraceStep:
    """The node's step, values only (no columns, multiplicities or flags)."""
    op = node.op
    rows = plan.rows(node)
    srcs = [(buffers[s], v) for s, v in node.srcs]
    ids = (node.id, node.srcs[0][0], node.srcs[1][0] if op in _BINARY else 0)
    dev = srcs[0][0].device
    in_mult = kernels.NEG1
    dsize = back = 1
    if op in _REDUCE:
        front, dsize, back = _reduce_dims(node)
        rows, n_out = front * back, front * back
    elif op == "contiguous":
        n_out = srcs[0][1].n_elements
        in_mult = (_P - srcs[0][1].expansion_factor()) % _P
    else:
        n_out = rows
    return kernels.TraceStep(
        op="lut" if op in _LUT_OPS else op, srcs=srcs, rows=rows,
        out=torch.empty(n_out, dtype=torch.int64, device=dev), ids=ids,
        out_mult=plan.out_mult[node.id], in_mult=in_mult, dsize=dsize, back=back,
    )


def _launch(step: kernels.TraceStep) -> None:
    if step.op in _BINARY:
        kernels.trace_binary(step)
    elif step.op in _REDUCE:
        kernels.trace_reduce(step)
    else:
        kernels.trace_unary(step)


def _release(plan: _Plan, node, pos: int, buffers) -> None:
    """Drop the buffers whose last consumer has run."""
    for s, _ in node.srcs:
        if plan.last_use.get(s) == pos and s not in plan.keep:
            buffers.pop(s, None)


def _raise_flags(flags: np.ndarray) -> None:
    for kind, bad in zip(_FLAGS, flags):
        if bad and kind == "max_reduce":
            raise LuminairError(
                "max_reduce step difference outside [0, 2^30) -- fixed-point values exceed the provable range"
            )
        if bad:
            raise LuminairError(f"{kind} input outside LUT range")


def _store_outputs(graph: Graph, values: Dict[int, np.ndarray]) -> None:
    """graph.output_data keyed by the retrieved node and by the producer
    ids the user's GraphTensor may still hold (as trace.py does)."""
    graph.output_data = {}
    for rid in graph.to_retrieve:
        node = graph.nodes[rid]
        data = fixed.to_float(values[rid])
        graph.output_data[rid] = data
        if node.op == "copy_from":
            src = node.srcs[0][0]
            graph.output_data[src] = data
            if graph.nodes[src].op == "copy_to":
                graph.output_data[graph.nodes[src].srcs[0][0]] = data


def _allocate(name: str, rows: int, dev: torch.device):
    """A table's int32 columns at their padded size, padding rows filled."""
    names = TABLE_COLUMNS[name]
    size = 1 << calculate_log_size(rows)
    storage = torch.empty((len(names), size), dtype=f.I32, device=dev)
    storage[:, rows:].fill_(0)
    for i, col in enumerate(names):
        pad = padding_value(name, col)
        if pad and rows < size:
            storage[i, rows:].fill_(pad)
    return names, storage


def gen_trace_device(graph: Graph, settings: CircuitSettings, dev: torch.device) -> LuminairPie:
    """Every PIE column written on `dev` by the trace kernels."""
    if not graph.compiled:
        graph.compile()
    plan = _Plan(graph)
    lk = settings.lookups
    layouts = {k: getattr(lk, k) for k in _LUT_OPS if getattr(lk, k) is not None}
    luts = {}
    for kind, layout in layouts.items():
        outs = layout.outputs if layout.outputs is not None else lut_reference_outputs(kind, layout.all_values())
        luts[kind] = (*layout.packed(), outs)
    buffers, lut_dev = plan.upload(dev, luts)

    storage = {name: _allocate(name, rows, dev) for name, rows in plan.table_rows.items()}
    mults = {k: torch.zeros(1 << layout.log_size, dtype=f.I32, device=dev) for k, layout in layouts.items()}
    rc = torch.zeros(1 << lk.range_check_bits, dtype=f.I32, device=dev) if lk.range_check_bits else None
    flags = torch.zeros(len(_FLAGS), dtype=f.I32, device=dev)

    blocks = {b.nid: b for b in plan.blocks}
    for pos, nid in enumerate(plan.order):
        node = graph.nodes[nid]
        op = node.op
        if op == "copy_from":
            buffers[nid] = buffers[node.srcs[0][0]]
        elif op != "function":
            b = blocks[nid]
            names, cols = storage[b.table]
            if op in ("copy_to", "constant"):
                src = buffers[node.srcs[0][0]] if op == "copy_to" else buffers[nid]
                step = kernels.TraceStep(op="inputs", srcs=[(src, View.contiguous((len(src),)))], rows=b.rows,
                                         ids=(nid, 0, 0), out_mult=plan.out_mult[nid])
                buffers[nid] = src
            else:
                step = _step(plan, node, buffers)
                if op in _LUT_OPS:
                    if op not in layouts:
                        raise LuminairError(f"{op} has no lookup table in the settings")
                    step.lut, step.mult = lut_dev[op], mults[op]
                elif op in ("less_than", "max_reduce"):
                    step.mult = rc
                if op in _LUT_OPS or op == "max_reduce":
                    k = _FLAGS.index(op)
                    step.flag = flags[k : k + 1]
                buffers[nid] = step.out
            step.cols = {c: cols[i, b.offset : b.offset + b.rows] for i, c in enumerate(names)}
            _launch(step)
        _release(plan, node, pos, buffers)

    # The one download: flags, then the retrieved outputs.
    rids = sorted(graph.to_retrieve)
    flat = torch.cat([flags.to(torch.int64)] + [buffers[r] for r in rids]).cpu().numpy()
    _raise_flags(flat[: len(_FLAGS)])
    values, at = {}, len(_FLAGS)
    for r in rids:
        values[r] = flat[at : at + len(buffers[r])]
        at += len(buffers[r])
    _store_outputs(graph, values)

    tables = {}
    for name, (names, st) in storage.items():
        rows = plan.table_rows[name]
        tables[name] = TraceTable(name, {c: st[i, :rows] for i, c in enumerate(names)},
                                  padded={c: st[i] for i, c in enumerate(names)})
    for kind, m in mults.items():
        tables[f"{kind}_lookup"] = TraceTable(f"{kind}_lookup", {"multiplicity": m}, padded={"multiplicity": m})
    if rc is not None:
        tables["range_check_lookup"] = TraceTable("range_check_lookup", {"multiplicity": rc},
                                                  padded={"multiplicity": rc})
    max_log = max(t.log_size for t in tables.values())
    return LuminairPie(tables, Metadata(ExecutionResources(dict(plan.op_counter), max_log)))


def gen_circuit_settings_device(graph: Graph, dev: torch.device) -> CircuitSettings:
    """The settings pre-pass on `dev`: every node's values by the trace
    kernels with no columns; at each LUT node one download of its gathered
    input and its source buffer's min / max (T4), f on the host, one
    upload."""
    if not graph.compiled:
        graph.compile()
    plan = _Plan(graph)
    buffers, _ = plan.upload(dev, {})
    flags = torch.zeros(len(_FLAGS), dtype=f.I32, device=dev)
    ranges = {k: [] for k in _LUT_OPS}
    for pos, nid in enumerate(plan.order):
        node = graph.nodes[nid]
        op = node.op
        if op in ("copy_to", "copy_from"):
            buffers[nid] = buffers[node.srcs[0][0]]
        elif op in _LUT_OPS:
            src, view = buffers[node.srcs[0][0]], node.srcs[0][1]
            gathered = kernels.TraceStep(op="contiguous", srcs=[(src, view)], rows=max(len(src), view.n_elements),
                                         out=torch.empty(view.n_elements, dtype=torch.int64, device=dev))
            kernels.trace_unary(gathered)
            host = torch.cat([kernels.lut_minmax(src), gathered.out]).cpu().numpy()
            ranges[op].append(lut_range(host[0], host[1]))
            out = fixed.from_float(LUT_FNS[op](fixed.to_float(host[2:])))
            buffers[nid] = torch.from_numpy(out).to(dev)
        elif op not in ("function", "constant"):
            step = _step(plan, node, buffers)
            if op == "max_reduce":
                k = _FLAGS.index(op)
                step.flag = flags[k : k + 1]
            _launch(step)
            buffers[nid] = step.out
        _release(plan, node, pos, buffers)
    _raise_flags(flags.cpu().numpy())
    return settings_from_ranges(ranges, any(n.op in ("less_than", "max_reduce") for n in graph.nodes))
