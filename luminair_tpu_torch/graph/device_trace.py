"""Trace generation on a torch device: the graph interpreter with every
trace column born on the device, already padded.

The host interpreter (trace.py ``_run``) is the spec; this module replays
the same per-op logic through the trace kernels (csrc/trace.cu).  The host
walks the graph once per pass (`_Layout`): it fixes each table's row
offsets (blocks in toposort order, as the host appends them), the op
counter and each node's yield multiplicity; gives every node's int64
output a place in one arena, the inputs first (a prefix of the same
offsets in both passes); and lists the pass's T1 and T2 nodes (and, in a
trace, each table's padding rows) as the items of one node table
(kernels.NodeTable), cut into segments at the reductions (and, in the
settings pass, at the LUT nodes) and, inside a segment, into phases: an
item's phase is one more than the latest phase of an item of its segment
whose output it reads.

Each graph keeps its inputs' fixed encoding resident on the device
(`_Resident`, `Graph.resident`): the arena's input prefix as the last pass
left it, with the generation (`Graph.input_generation`, bumped by each
`GraphTensor.set`) each input's encoding holds.  A pass takes that prefix
with one copy on the device, and stages and encodes only the inputs `set`
since (all of them where the record does not hold: another device, input
list or length).  Their float64 bits (unconverted), the fixed-encoded
constants, the LUT tables and the node table go to the device in one copy;
then each segment is one launch of kernels.trace_segment and each
reduction one of trace_reduce, writing their rows in place.  The first
segment's items begin with one "encode" item a staged input, which writes
the input's fixed encoding (fixed.from_float, bit for bit) into the input's
region of the arena: a reader at its own row joins the encode's chain, any
other reader waits for a later phase.  After the launches the encoded
regions are copied back into the record.  Each pass counts the values it
took from the record (`tracing.RESIDENT_INPUTS`), the ones it encoded
(`ENCODED_INPUTS`) and the staged bytes of inputs not `set` since the
graph's last pass (`tracing.H2D_REPEAT`).
The only downloads are the range flags and the retrieved outputs,
together, at the end; the PIE's columns stay where they were written and
prove() reads them there.  On CPU tensors the kernels' plain twins do the
same work.

The settings pre-pass cannot read LUT outputs (the LUTs do not exist yet),
so a LUT node's gathered input ends its segment; T4 writes the node's
boundary (the min / max of the raw source buffer, then the gathered input)
into a staging region, the host downloads it in one copy into pinned
memory, applies f in float64 exactly as the host pre-pass does (the
device's sin and exp2 are not numpy's), and uploads the result from
pinned memory as the node's output.

Each pass is a root span of its request (tracing, kinds "trace" and
"settings"; the settings pass makes the request's id and gives it to the
settings it returns) with its sub-spans, which end with a device
synchronise only while tracing listens.  No host step relies on a span's
end: each download waits for the stream (`.cpu()`, or the explicit stream
synchronise after the LUT boundary's copy), and the pinned host buffer of
the LUT round trips is written again only after that wait.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import fields as f
from .. import fixed
from .. import kernels
from .. import tracing
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
#: The counter of the input values a pass's encode items turn into fixed
#: point (in its `launches` span).
ENCODED_INPUTS = "encoded_inputs"

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
_RANGE_CHECK = "range_check"  # the range-check histogram's name in TraceBuffers.hists


@dataclass
class _Resident:
    """A graph's inputs in fixed point on one device: `values` is the arena's
    input prefix (`shape`: (input id, length) in its order) as the graph's
    last pass left it; `generation` the input's generation each encoding
    holds."""

    shape: tuple
    values: torch.Tensor
    generation: Dict[int, int]


def _input_shape(plan: "_Plan") -> tuple:
    return tuple((nid, plan.graph.nodes[nid].out_len) for nid in plan.input_ids)


def _resident(plan: "_Plan", dev: torch.device) -> Optional[_Resident]:
    """The graph's record where it holds the plan's inputs on `dev`, else
    None."""
    rec = plan.graph.resident
    if rec is None or rec.values.device != dev or rec.shape != _input_shape(plan):
        return None
    return rec


@dataclass
class _Block:
    nid: int
    table: str
    offset: int  # first row of the node in its table
    rows: int


class _Plan:
    """The host's one walk of the graph: tables, blocks, multiplicities."""

    def __init__(self, graph: Graph):
        self.graph = graph
        self.order = graph.toposort()
        self.blocks: Dict[int, _Block] = {}
        self.table_rows: Dict[str, int] = {}  # tables in the order of their first block
        self.op_counter: Dict[str, int] = defaultdict(int)
        for nid in self.order:
            node = graph.nodes[nid]
            if node.op not in DEVICE_OPS:
                raise LuminairError(f"op {node.op} has no trace kernel")
            if node.op in ("function", "copy_from"):
                continue
            table = "inputs" if node.op in ("copy_to", "constant") else node.op
            rows = self.rows(node)
            if rows >= 1 << 31:
                raise LuminairError(f"node {nid} ({node.op}) writes {rows} rows; the trace takes fewer than 2^31")
            self.blocks[nid] = _Block(nid, table, self.table_rows.get(table, 0), rows)
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

    def rows(self, node) -> int:
        """The rows a node writes in its table."""
        if node.op == "copy_to":
            return self.graph.nodes[node.srcs[0][0]].out_len
        if node.op == "constant":
            return 1
        if node.op in _REDUCE:
            front, dsize, back = _reduce_dims(node)
            return front * dsize * back
        src, view = node.srcs[0]
        if node.op == "contiguous":
            return max(self.graph.nodes[src].out_len, view.n_elements)
        return view.n_elements

    def out_len(self, node) -> int:
        """The length of a computed node's int64 output."""
        if node.op in _REDUCE:
            front, _, back = _reduce_dims(node)
            return front * back
        if node.op == "contiguous":
            return node.srcs[0][1].n_elements
        return self.rows(node)


def _reduce_dims(node):
    sh = node.srcs[0][1].shape
    dim = node.params["dim"]
    return int(np.prod(sh[:dim])) if dim > 0 else 1, sh[dim], int(np.prod(sh[dim + 1 :])) if dim + 1 < len(sh) else 1


class _Chain:
    """Items of one phase and one row count, each reading the phase's
    outputs only at its own row (`_row_aligned`) from earlier items of the
    chain."""

    def __init__(self, rows: int, phase: int):
        self.rows, self.phase, self.items = rows, phase, []


def _row_aligned(view: View, length: int, rows: int) -> bool:
    """Whether row r of a node of `rows` rows reads element r of the
    `length` elements through `view` (and nothing else of them)."""
    ndim, sizes, strides, los, his, base, _, _ = view.packed()
    return length == rows and ndim == 1 and sizes[0] == rows and strides[0] == 1 and base == 0 and \
        los[0] == 0 and his[0] == rows


class _Layout:
    """One pass on the device, planned on the host: every node's output as a
    region (offset, length) of one int64 arena -- the encoded inputs and
    the computed outputs first, then the uploaded inputs' float64 bits
    (`raw`), constants and LUT tables (`parts`, from `at_data`), then the
    node table (at `at_table`); the node table's
    items, chains, phases and segments; and `program`, the pass's launches
    in order: ("segment", k), ("reduce", node id) and, in the settings
    pass, ("lut", node id) after the segment that gathers the LUT's input
    into `gathered[node id]`.

    An item's phase is the least that is later than the phase of every
    output of its segment it reads, but the ones it reads at its own row
    from a chain of its row count: it joins that chain (merging the chains
    of its phase it so reads)."""

    def __init__(self, plan: _Plan, luts: Dict[str, tuple], trace: bool, range_check: bool = False,
                 resident: Optional[_Resident] = None):
        g = plan.graph
        self.plan, self.trace, self.resident = plan, trace, resident
        gen = g.input_generation
        # the inputs `set` since the record's encoding, at their generations now
        self.generation = {nid: gen.get(nid, 0) for nid in plan.input_ids
                           if resident is None or resident.generation.get(nid) != gen.get(nid, 0)}
        self.region: Dict[int, tuple] = {}
        self.gathered: Dict[int, tuple] = {}
        at = 0
        for nid in plan.input_ids:  # the encode items write them, or the copy from the graph's record
            n = g.nodes[nid].out_len
            self.region[nid] = (at, n)
            at += n
        self.n_inputs = at
        for nid in plan.order:
            node = g.nodes[nid]
            if node.op in ("function", "constant", "copy_to", "copy_from"):
                continue
            n = plan.out_len(node)
            self.region[nid] = (at, n)
            at += n
            if not trace and node.op in _LUT_OPS:
                self.gathered[nid] = (at, n)
                at += n
        self.at_data = at
        self.parts = []

        def put(a):
            nonlocal at
            self.parts.append(a)
            at += len(a)
            return (at - len(a), len(a))

        self.raw = {nid: put(np.ascontiguousarray(g.input_data.get(nid, np.zeros(g.nodes[nid].out_len)),
                                                  dtype=np.float64).view(np.int64))
                    for nid in self.generation}
        self.encoded = sum(n for _, n in self.raw.values())
        for nid in plan.order:
            if g.nodes[nid].op == "constant":
                self.region[nid] = put(fixed.from_float(np.array([g.nodes[nid].params["value"]])))
        self.luts = {kind: tuple(put(np.asarray(a, dtype=np.int64)) for a in arrays) for kind, arrays in luts.items()}
        self.at_table = at
        self._walk(luts, range_check)
        self.n_words = at + kernels.NodeTable.n_words(len(self.items), len(self.chains), len(self.phases))

    def _walk(self, luts, range_check: bool) -> None:
        plan, g, region = self.plan, self.plan.graph, self.region
        self.items: List[kernels.TraceItem] = []
        self.chains: List[tuple] = []
        self.phases: List[tuple] = []
        self.segments: List[tuple] = []
        self.program: List[tuple] = []
        phases: List[List[_Chain]] = []  # of the open segment
        written: Dict[int, _Chain] = {}  # arena offset: the chain of the open segment that writes it

        def close():
            if not phases:
                return
            p0 = len(self.phases)
            for chains in phases:
                c0 = len(self.chains)
                for ch in chains:
                    self.chains.append((len(self.items), len(ch.items)))
                    self.items += ch.items
                self.phases.append((c0, len(chains)))
            self.segments.append((p0, len(self.phases)))
            self.program.append(("segment", len(self.segments) - 1))
            phases.clear()
            written.clear()

        def add(it):
            it.fresh = tuple(k for k, (off, _, _) in enumerate(it.srcs) if off in written)
            deps = [(written[off], n, v) for off, n, v in it.srcs if off in written]
            aligned = [ch.rows == it.rows and _row_aligned(v, n, it.rows) for ch, n, v in deps]
            phase = max((ch.phase + (not ok) for (ch, _, _), ok in zip(deps, aligned)), default=0)
            join = []
            for ch, _, _ in deps:
                if ch.phase == phase and ch not in join:
                    join.append(ch)
            if join:
                chain = join[0]
                for other in join[1:]:  # independent chains of one phase and row count: one after the other
                    chain.items += other.items
                    phases[phase].remove(other)
                    for off, ch in written.items():
                        if ch is other:
                            written[off] = chain
            else:
                chain = _Chain(it.rows, phase)
                if phase == len(phases):
                    phases.append([])
                phases[phase].append(chain)
            chain.items.append(it)
            if it.out:
                written[it.out[0]] = chain

        for nid, (off, n) in self.raw.items():
            add(kernels.TraceItem("encode", n, ((off, n, View.contiguous((n,))),), out=region[nid]))
        if self.trace:
            for it in self._padding():
                add(it)
        for nid in plan.order:
            node = g.nodes[nid]
            op = node.op
            if op == "function" or (op == "constant" and not self.trace):
                continue
            if op in ("copy_from", "copy_to"):
                region[nid] = region[node.srcs[0][0]]
                if op == "copy_from" or not self.trace:
                    continue
            if op in _REDUCE:
                close()
                self.program.append(("reduce", nid))
            elif op in ("copy_to", "constant"):
                b = plan.blocks[nid]
                off, n = region[nid]
                add(kernels.TraceItem("inputs", b.rows, ((off, n, View.contiguous((n,))),), table="inputs",
                                      row0=b.offset, ids=(nid, 0, 0), out_mult=plan.out_mult[nid]))
            elif op in _LUT_OPS and not self.trace:
                src, view = node.srcs[0]
                add(kernels.TraceItem("contiguous", max(region[src][1], view.n_elements), ((*region[src], view),),
                                      out=self.gathered[nid]))
                close()
                self.program.append(("lut", nid))
            else:
                add(self._item(node, luts, range_check))
        close()

    def _item(self, node, luts, range_check: bool) -> kernels.TraceItem:
        """A T1 or T2 node's item (in the settings pass, values only)."""
        plan, op = self.plan, node.op
        in_mult = (_P - node.srcs[0][1].expansion_factor()) % _P if op == "contiguous" else kernels.NEG1
        it = kernels.TraceItem(
            "lut" if op in _LUT_OPS else op, plan.rows(node), tuple((*self.region[s], v) for s, v in node.srcs),
            out=self.region[node.id], ids=(node.id, node.srcs[0][0], node.srcs[1][0] if op in _BINARY else 0),
            out_mult=plan.out_mult[node.id], in_mult=in_mult,
        )
        if self.trace:
            b = plan.blocks[node.id]
            it.table, it.row0 = b.table, b.offset
            if op in _LUT_OPS:
                if op not in luts:
                    raise LuminairError(f"{op} has no lookup table in the settings")
                it.lut, it.hist, it.flag = op, op, _FLAGS.index(op)
            elif op == "less_than" and range_check:
                it.hist = _RANGE_CHECK
        return it

    def _padding(self) -> List[kernels.TraceItem]:
        """Each table's padding rows, one item per padding value."""
        items = []
        for name, rows in self.plan.table_rows.items():
            pad = (1 << calculate_log_size(rows)) - rows
            if pad == 0:
                continue
            by_value = defaultdict(list)
            for col in TABLE_COLUMNS[name]:
                by_value[padding_value(name, col)].append(col)
            for value, cols in by_value.items():
                items.append(kernels.TraceItem("pad", pad, table=name, row0=rows, columns=tuple(cols),
                                               out_mult=value))
        return items

    def reduce_step(self, buffers: kernels.TraceBuffers, nid: int) -> kernels.TraceStep:
        """T3's step for a reduction node: slices of the buffers."""
        plan, node = self.plan, self.plan.graph.nodes[nid]
        front, dsize, back = _reduce_dims(node)
        src, view = node.srcs[0]
        (so, sn), (oo, on) = self.region[src], self.region[nid]
        arena = buffers.arena
        step = kernels.TraceStep(op=node.op, srcs=[(arena[so : so + sn], view)], rows=front * back,
                                 out=arena[oo : oo + on], ids=(nid, src, 0), out_mult=plan.out_mult[nid],
                                 dsize=dsize, back=back)
        if node.op == "max_reduce":
            k = _FLAGS.index("max_reduce")
            step.flag = buffers.flags[k : k + 1]
        if self.trace:
            b = plan.blocks[nid]
            names, st = buffers.storage[b.table]
            step.cols = {c: st[i, b.offset : b.offset + b.rows] for i, c in enumerate(names)}
            if node.op == "max_reduce":
                step.mult = buffers.hists.get(_RANGE_CHECK)
        return step

    def table(self, buffers: kernels.TraceBuffers) -> kernels.NodeTable:
        """The pass's node table over `buffers`."""
        return kernels.NodeTable(buffers, self.items, self.chains, self.phases, self.segments, self.at_table)

    def repeated(self, last: Optional[_Resident]) -> int:
        """The bytes (8 a value) of the inputs the pass stages whose
        generation is the one the graph's last record holds: not `set`
        since, staged again because that record does not hold here."""
        held = {} if last is None else last.generation
        return sum(8 * self.region[nid][1] for nid, gen in self.generation.items() if held.get(nid) == gen)

    def upload(self, table: kernels.NodeTable, words: np.ndarray) -> None:
        """The resident inputs' encoding into the arena's prefix (one copy on
        the device), then the pass's one host-to-device copy: the staged
        inputs' float64 bits, the constants and LUT tables, the node table's
        `words`, staged once (in pinned memory for a card) into the arena's
        tail."""
        arena = table.buffers.arena
        if self.encoded < self.n_inputs:
            arena[: self.n_inputs].copy_(self.resident.values)
        n = arena.numel() - self.at_data
        stage = torch.empty(n, dtype=torch.int64, pin_memory=arena.is_cuda)
        host, at = stage.numpy(), 0
        for a in self.parts + [words]:
            host[at : at + len(a)] = a
            at += len(a)
        f.copy(arena[self.at_data :], stage, non_blocking=arena.is_cuda)

    def keep(self, arena: torch.Tensor) -> None:
        """After the launches, where the pass encoded inputs: the arena's
        input prefix into the graph's record (one copy on the device; a new
        record where none held)."""
        if not self.generation:
            return
        prefix = arena[: self.n_inputs]
        rec = self.resident or _Resident(_input_shape(self.plan), torch.empty_like(prefix), {})
        rec.values.copy_(prefix)
        rec.generation.update(self.generation)
        self.plan.graph.resident = rec


def _upload(layout: _Layout, table: kernels.NodeTable, words: np.ndarray) -> None:
    """A pass's `upload` span: the copies and their counters."""
    layout.upload(table, words)
    tracing.count(tracing.H2D_REPEAT, layout.repeated(layout.plan.graph.resident))
    tracing.count(tracing.RESIDENT_INPUTS, layout.n_inputs - layout.encoded)


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


def gen_trace_device(graph: Graph, settings: CircuitSettings, dev: torch.device) -> LuminairPie:
    """Every PIE column written on `dev` by the trace kernels."""
    if not graph.compiled:
        graph.compile()
    with tracing.root("trace", tracing.request_of(settings), dev):
        return _trace_pass(graph, settings, dev)


def _trace_pass(graph: Graph, settings: CircuitSettings, dev: torch.device) -> LuminairPie:
    span = tracing.span
    with span("plan"):
        plan = _Plan(graph)
        lk = settings.lookups
        layouts = {k: getattr(lk, k) for k in _LUT_OPS if getattr(lk, k) is not None}
        luts = {}
        for kind, layout in layouts.items():
            outs = layout.outputs if layout.outputs is not None else lut_reference_outputs(kind, layout.all_values())
            luts[kind] = (*layout.packed(), outs)
    with span("walk"):
        layout = _Layout(plan, luts, trace=True, range_check=bool(lk.range_check_bits),
                         resident=_resident(plan, dev))
    with span("allocate"):
        storage = {}
        for name, rows in plan.table_rows.items():
            names = TABLE_COLUMNS[name]
            storage[name] = (names, torch.empty((len(names), 1 << calculate_log_size(rows)), dtype=f.I32, device=dev))
        hists = {k: torch.zeros(1 << lay.log_size, dtype=f.I32, device=dev) for k, lay in layouts.items()}
        if lk.range_check_bits:
            hists[_RANGE_CHECK] = torch.zeros(1 << lk.range_check_bits, dtype=f.I32, device=dev)
        flags = torch.zeros(len(_FLAGS), dtype=f.I32, device=dev)
        buffers = kernels.TraceBuffers(torch.empty(layout.n_words, dtype=torch.int64, device=dev), storage, hists,
                                       flags, layout.luts)
    with span("pack"):
        table = layout.table(buffers)
        words = table.pack()
    with span("upload"):
        _upload(layout, table, words)
    with span("launches"):
        tracing.count(ENCODED_INPUTS, layout.encoded)
        for what, k in layout.program:
            if what == "segment":
                kernels.trace_segment(table.segment(k))
            else:
                kernels.trace_reduce(layout.reduce_step(buffers, k))
        layout.keep(buffers.arena)

    with span("download"):  # the one download: flags, then the retrieved outputs
        rids = sorted(graph.to_retrieve)
        arena = buffers.arena
        outs = [arena[o : o + n] for o, n in (layout.region[r] for r in rids)]
        flat = f.to_host(torch.cat([flags.to(torch.int64)] + outs)).numpy()
        _raise_flags(flat[: len(_FLAGS)])
        values, at = {}, len(_FLAGS)
        for r, o in zip(rids, outs):
            values[r] = flat[at : at + len(o)]
            at += len(o)
        _store_outputs(graph, values)

    with span("assembly"):
        tables = {}
        for name, (names, st) in storage.items():
            rows = plan.table_rows[name]
            tables[name] = TraceTable(name, {c: st[i, :rows] for i, c in enumerate(names)},
                                      padded={c: st[i] for i, c in enumerate(names)})
        for kind in layouts:
            m = hists[kind]
            tables[f"{kind}_lookup"] = TraceTable(f"{kind}_lookup", {"multiplicity": m}, padded={"multiplicity": m})
        if _RANGE_CHECK in hists:
            rc = hists[_RANGE_CHECK]
            tables["range_check_lookup"] = TraceTable("range_check_lookup", {"multiplicity": rc},
                                                      padded={"multiplicity": rc})
        max_log = max(t.log_size for t in tables.values())
        pie = LuminairPie(tables, Metadata(ExecutionResources(dict(plan.op_counter), max_log)))
    return pie


def gen_circuit_settings_device(graph: Graph, dev: torch.device) -> CircuitSettings:
    """The settings pre-pass on `dev`: every node's values by the trace
    kernels with no columns; at each LUT node its boundary (T4: the source
    buffer's min / max and the gathered input, in one staging region the
    pass holds) copied in one download into a pinned host buffer the pass
    holds, f on the host, its outputs uploaded from that buffer."""
    if not graph.compiled:
        graph.compile()
    rid = tracing.new_request()
    with tracing.root("settings", rid, dev):
        settings = _settings_pass(graph, dev)
    settings.request = rid
    return settings


def _settings_pass(graph: Graph, dev: torch.device) -> CircuitSettings:
    span = tracing.span
    with span("plan"):
        plan = _Plan(graph)
    with span("walk"):
        layout = _Layout(plan, {}, trace=False, resident=_resident(plan, dev))
    with span("allocate"):
        flags = torch.zeros(len(_FLAGS), dtype=f.I32, device=dev)
        buffers = kernels.TraceBuffers(torch.empty(layout.n_words, dtype=torch.int64, device=dev), flags=flags)
        luts = [k for what, k in layout.program if what == "lut"]
        src = {k: layout.region[graph.nodes[k].srcs[0][0]] for k in luts}
        staging = torch.zeros(max((kernels.lut_boundary_words(src[k][1], layout.gathered[k][1]) for k in luts),
                                  default=0), dtype=torch.int64, device=dev)
        host = torch.empty(max((max(layout.gathered[k][1] + 2, layout.region[k][1]) for k in luts), default=0),
                           dtype=torch.int64, pin_memory=dev.type == "cuda")
    with span("pack"):
        table = layout.table(buffers)
        words = table.pack()
    with span("upload"):
        _upload(layout, table, words)
    ranges = {k: [] for k in _LUT_OPS}
    arena = buffers.arena
    with span("launches"):  # each LUT's round trip inside it
        tracing.count(ENCODED_INPUTS, layout.encoded)
        for what, k in layout.program:
            if what == "segment":
                kernels.trace_segment(table.segment(k))
            elif what == "reduce":
                kernels.trace_reduce(layout.reduce_step(buffers, k))
            else:
                node = graph.nodes[k]
                (so, sn), (go, gn), (oo, on) = src[k], layout.gathered[k], layout.region[k]
                with span("lut_boundary"):
                    boundary = kernels.lut_boundary(arena[so : so + sn], arena[go : go + gn], staging)
                with span("lut_download"):
                    got = host[: gn + 2]
                    f.copy(got, boundary, non_blocking=True)
                    if dev.type == "cuda":  # the host reads `got` and then rewrites `host`: both wait for this
                        torch.cuda.current_stream(dev).synchronize()
                    got = got.numpy()
                with span("lut_f"):
                    ranges[node.op].append(lut_range(got[0], got[1]))
                    out = fixed.from_float(LUT_FNS[node.op](fixed.to_float(got[2:])))
                with span("lut_upload"):
                    host[:on].numpy()[:] = out
                    f.copy(arena[oo : oo + on], host[:on], non_blocking=True)
        layout.keep(arena)
    with span("flags"):
        with span("download"):
            _raise_flags(f.to_host(flags).numpy())
        with span("settings_from_ranges"):
            return settings_from_ranges(ranges, any(n.op in ("less_than", "max_reduce") for n in graph.nodes))
