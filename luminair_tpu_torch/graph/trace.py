"""Graph execution and trace capture: gen_circuit_settings / gen_trace /
execute.

gen_circuit_settings and gen_trace run on a torch device, the current CUDA
device unless the caller passes `device` ("cpu" runs the same device
interpreter through the kernels' plain twins): graph/device_trace.py.  The
host numpy interpreter here is the spec the device interpreter is held to,
reached under its own names (gen_circuit_settings_host, gen_trace_host);
execute() stays on the host.  It resolves each op's input views with one
gather, computes in vectorized int64 fixed point, and appends whole column
blocks to the trace tables; LUT multiplicities are scatter-adds (np.add.at /
bincount).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np

from .. import fixed
from ..air.pie import (
    ExecutionResources,
    LuminairPie,
    Metadata,
    TraceTable,
)
from ..air.preprocessed import LUT_FNS, LookupLayout, Range, coalesce_ranges, finalize_lookups
from ..air.settings import CircuitSettings, Lookups
from ..errors import LuminairError
from .graph import Graph

RANGE_MARGIN = 0.10  # reference crates/graph/src/utils.rs:69-82
NEG1 = np.uint32((1 << 31) - 2)  # -1 in M31


def lut_range(lo_raw, hi_raw) -> Range:
    """A LUT node's range from its raw source buffer's min and max, with
    margin (reference utils.rs:45-82)."""
    lo, hi = fixed.to_float(lo_raw), fixed.to_float(hi_raw)
    delta = (hi - lo) * RANGE_MARGIN
    return Range(int(fixed.from_float(lo - delta)), int(fixed.from_float(hi + delta)))


def settings_from_ranges(ranges: Dict[str, list], range_check: bool) -> CircuitSettings:
    lk = Lookups()
    for kind in ("sin", "exp2", "log2"):
        if ranges[kind]:
            setattr(lk, kind, LookupLayout(coalesce_ranges(ranges[kind])))
    if range_check:
        lk.range_check_bits = 8
    finalize_lookups(lk)  # normative LUT output bytes (see preprocessed.py)
    return CircuitSettings(lookups=lk)


class _TableBuilder:
    def __init__(self):
        self.blocks: List[Dict[str, np.ndarray]] = []

    def append(self, **cols):
        n = max(
            (len(v) for v in cols.values() if np.ndim(v) > 0), default=1
        )
        blk = {}
        for k, v in cols.items():
            arr = np.asarray(v)
            if arr.ndim == 0:
                arr = np.full(n, arr)
            blk[k] = arr.astype(np.uint32)
        self.blocks.append(blk)

    def build(self, name) -> Optional[TraceTable]:
        if not self.blocks:
            return None
        cols = {
            k: np.concatenate([b[k] for b in self.blocks])
            for k in self.blocks[0]
        }
        return TraceTable(name, cols)


def _common(node_id, n, extra_ids):
    idx = np.arange(n, dtype=np.uint32)
    is_last = (idx == n - 1).astype(np.uint32)
    cols = dict(
        node_id=np.uint32(node_id),
        idx=idx,
        is_last_idx=is_last,
        next_node_id=np.uint32(node_id),
        next_idx=idx + 1,
    )
    for k, v in extra_ids.items():
        cols[k] = np.uint32(v)
        cols["next_" + k] = np.uint32(v)
    return cols


def _run(graph: Graph, record_trace: bool, settings: Optional[CircuitSettings],
         collect_ranges: bool):
    """Shared interpreter for execute / settings pre-pass / trace gen."""
    if not graph.compiled:
        graph.compile()
    order = graph.toposort()
    buffers: Dict[int, np.ndarray] = {}  # node -> int64 fixed values
    float_buffers: Dict[int, np.ndarray] = {}

    tables = defaultdict(_TableBuilder)
    op_counter: Dict[str, int] = defaultdict(int)
    ranges = {"sin": [], "exp2": [], "log2": []}
    range_check_needed = False

    # LUT multiplicity accumulators (trace mode).
    lut_mults = {}
    rc_mults = None
    if record_trace and settings is not None:
        for kind in ("sin", "exp2", "log2"):
            layout = getattr(settings.lookups, kind)
            if layout is not None:
                lut_mults[kind] = np.zeros(1 << layout.log_size, dtype=np.int64)
        if settings.lookups.range_check_bits:
            rc_mults = np.zeros(1 << settings.lookups.range_check_bits, dtype=np.int64)

    def out_mult(nid):
        # In-proof consumer count (copy_from excluded): a pure final output
        # yields 0, a tensor that is both retrieved and consumed yields its
        # real consumption so the LogUp argument stays balanced.
        return np.uint32(graph.expansion_adjusted_consumers(nid) % ((1 << 31) - 1))

    for nid in order:
        node = graph.nodes[nid]
        op = node.op
        srcs = [(buffers.get(s), v) for s, v in node.srcs]

        if op == "function":
            float_buffers[nid] = graph.input_data.get(
                nid, np.zeros(node.out_len, dtype=np.float64)
            )
            continue

        if op == "copy_to":
            src_id = node.srcs[0][0]
            data = fixed.from_float(float_buffers[src_id])
            buffers[nid] = data
            if record_trace:
                n = len(data)
                cols = _common(nid, n, {})
                cols["val"] = fixed.to_m31(data)
                cols["multiplicity"] = out_mult(nid)
                tables["inputs"].append(**cols)
                op_counter["inputs"] += 1
            continue

        if op == "constant":
            data = fixed.from_float(np.array([node.params["value"]]))
            buffers[nid] = data
            if record_trace:
                cols = _common(nid, 1, {})
                cols["val"] = fixed.to_m31(data)
                cols["multiplicity"] = out_mult(nid)
                tables["inputs"].append(**cols)
                op_counter["inputs"] += 1
            continue

        if op == "copy_from":
            src_id = node.srcs[0][0]
            buffers[nid] = buffers[src_id]
            continue

        # LUT range tracking (settings pre-pass): raw source-buffer min/max
        # with margin (reference utils.rs:45-82).
        if collect_ranges and op in ("sin", "exp2", "log2"):
            buf = srcs[0][0]
            ranges[op].append(lut_range(buf.min(), buf.max()))
        if collect_ranges and op in ("less_than", "max_reduce"):
            # max_reduce range-proves its running-max steps through the
            # 8-bit range-check relation (soundness fix over the reference).
            range_check_needed = True

        # ---- compute + trace emission per primitive --------------------
        if op in ("add", "mul", "rem", "less_than"):
            (abuf, av), (bbuf, bv) = srcs
            lhs = av.gather(abuf)
            rhs = bv.gather(bbuf)
            n = len(lhs)
            ids = {"lhs_id": node.srcs[0][0], "rhs_id": node.srcs[1][0]}
            if op == "add":
                out = fixed.add(lhs, rhs)
                extra = {}
            elif op == "mul":
                out, rem = fixed.mul(lhs, rhs)
                extra = {"rem": fixed.to_m31(rem)}
            elif op == "rem":
                quot, out = fixed.div_rem(lhs, rhs)
                extra = {"quotient": fixed.to_m31(quot)}
            else:  # less_than
                out, borrow, diff = fixed.less_than(lhs, rhs)
                diff_u32 = diff.astype(np.uint64).astype(np.uint32)
                extra = {
                    "borrow": borrow.astype(np.uint32),
                    "diff": fixed.to_m31(diff),
                    "limb0": (diff_u32 & 0xFF),
                    "limb1": ((diff_u32 >> 8) & 0xFF),
                    "limb2": ((diff_u32 >> 16) & 0xFF),
                    "limb3": ((diff_u32 >> 24) & 0xFF),
                }
                if record_trace and rc_mults is not None:
                    for k in ("limb0", "limb1", "limb2", "limb3"):
                        rc_mults += np.bincount(extra[k], minlength=len(rc_mults))
            buffers[nid] = out
            if record_trace:
                cols = _common(nid, n, ids)
                cols["lhs"] = fixed.to_m31(lhs)
                cols["rhs"] = fixed.to_m31(rhs)
                if op == "rem":
                    cols["rem"] = fixed.to_m31(out)
                else:
                    cols["out"] = fixed.to_m31(out)
                cols.update(extra)
                cols["lhs_mult"] = NEG1
                cols["rhs_mult"] = NEG1
                cols["out_mult"] = out_mult(nid)
                if op == "less_than":
                    cols["range_check_mult"] = np.uint32(1)
                tables[op].append(**cols)
                op_counter[op] += 1

        elif op in ("recip", "square", "sqrt", "sin", "exp2", "log2", "contiguous"):
            buf, view = srcs[0]
            inp = view.gather(buf)
            ids = {"input_id": node.srcs[0][0]}
            if op == "recip":
                out, rem = fixed.recip(inp)
                extra = {"rem": fixed.to_m31(rem), "scale": np.uint32(1 << fixed.DEFAULT_FP_SCALE)}
            elif op == "square":
                out, rem = fixed.square(inp)
                extra = {"rem": fixed.to_m31(rem)}
            elif op == "sqrt":
                out, rem = fixed.sqrt(inp)
                extra = {"rem": fixed.to_m31(rem), "scale": np.uint32(1 << fixed.DEFAULT_FP_SCALE)}
            elif op in ("sin", "exp2", "log2"):
                layout = getattr(settings.lookups, op) if settings is not None else None
                pos = None
                if layout is not None:
                    pos = layout.find_index(inp)
                    if np.any(pos < 0):
                        raise LuminairError(f"{op} input outside LUT range")
                if layout is not None and layout.outputs is not None:
                    # Witness outputs come from the NORMATIVE table bytes, so
                    # the LUT relation [input, out] balances against the
                    # committed preprocessed column on any machine/libm.
                    out = layout.outputs[pos]
                else:  # settings pre-pass (range discovery) or legacy settings
                    out = fixed.from_float(LUT_FNS[op](fixed.to_float(inp)))
                extra = {"lookup_mult": np.uint32(1)}
                if record_trace and op in lut_mults:
                    np.add.at(lut_mults[op], pos, 1)
            else:  # contiguous
                out = inp
                extra = None
            if op == "contiguous":
                n_in = len(buf)
                n_out = len(inp)
                n = max(n_in, n_out)
                raw = np.zeros(n, dtype=np.int64)
                raw[:n_in] = buf
                gathered = np.zeros(n, dtype=np.int64)
                gathered[:n_out] = inp
                # consume the raw buffer element-by-element (this is what
                # keeps slices LogUp-balanced -- reference op/prim.rs:253-301);
                # rows beyond the input length consume nothing (improvement
                # over the reference, which consumed (0, id) there).  Each
                # raw element is consumed F times, F = the edge's broadcast
                # factor: the producer yields every element F times through
                # this view (expansion_adjusted_consumers), whether or not a
                # slice actually references it.
                factor = view.expansion_factor()
                input_mult = np.zeros(n, dtype=np.uint32)
                input_mult[:n_in] = np.uint32(((1 << 31) - 1 - factor) % ((1 << 31) - 1))
                om = np.zeros(n, dtype=np.uint32)
                om[:n_out] = out_mult(nid)
                buffers[nid] = out
                if record_trace:
                    cols = _common(nid, n, ids)
                    cols["input"] = fixed.to_m31(raw)
                    cols["out"] = fixed.to_m31(gathered)
                    cols["input_mult"] = input_mult
                    cols["out_mult"] = om
                    tables["contiguous"].append(**cols)
                    op_counter["contiguous"] += 1
            else:
                buffers[nid] = out
                if record_trace:
                    n = len(inp)
                    cols = _common(nid, n, ids)
                    cols["input"] = fixed.to_m31(inp)
                    cols["out"] = fixed.to_m31(out)
                    cols.update(extra)
                    cols["input_mult"] = NEG1
                    cols["out_mult"] = out_mult(nid)
                    tables[op].append(**cols)
                    op_counter[op] += 1

        elif op in ("sum_reduce", "max_reduce"):
            buf, view = srcs[0]
            dim = node.params["dim"]
            sh = view.shape
            front = int(np.prod(sh[:dim])) if dim > 0 else 1
            dsize = sh[dim]
            back = int(np.prod(sh[dim + 1 :])) if dim + 1 < len(sh) else 1
            vals = view.gather(buf).reshape(front, dsize, back)
            # row order: (i, j, k) -- per output element, walk the axis
            v = np.moveaxis(vals, 1, 2)  # (front, back, dim)
            flat = v.reshape(-1, dsize)  # rows: (i*back + j, k)
            n_rows = flat.size
            out_idx = np.repeat(np.arange(front * back, dtype=np.uint32), dsize)
            is_last_step = np.tile(
                (np.arange(dsize) == dsize - 1).astype(np.uint32), front * back
            )
            if op == "sum_reduce":
                inc = np.cumsum(flat, axis=1)
                acc = inc - flat  # exclusive prefix
                nxt = inc
                outv = inc[:, -1]
                extra_names = ("acc", "next_acc")
            else:
                run = np.maximum.accumulate(flat, axis=1)
                acc = np.concatenate([flat[:, :1], run[:, :-1]], axis=1)
                nxt = run
                outv = run[:, -1]
                is_max = (flat > acc).astype(np.uint32).reshape(-1)
                extra_names = ("max_val", "next_max_val")
                # >= witness: d = next_max - loser, range-proved < 2^30
                # via 8/8/8/6-bit limbs (see MaxReduceComponent).
                loser = np.where(flat > acc, acc, flat)
                ge_d = (nxt - loser).reshape(-1)
                if np.any(ge_d < 0) or np.any(ge_d >= 1 << 30):
                    raise LuminairError(
                        "max_reduce step difference outside [0, 2^30) -- "
                        "fixed-point values exceed the provable range"
                    )
                ge_u32 = ge_d.astype(np.uint32)
            buffers[nid] = outv.copy()
            if record_trace:
                om = out_mult(nid)
                out_col = np.where(
                    is_last_step.astype(bool), np.repeat(fixed.to_m31(outv), dsize), 0
                ).astype(np.uint32)
                cols = dict(
                    node_id=np.uint32(nid),
                    input_id=np.uint32(node.srcs[0][0]),
                    idx=out_idx,
                    is_last_idx=(out_idx == front * back - 1).astype(np.uint32),
                    next_node_id=np.uint32(nid),
                    next_input_id=np.uint32(node.srcs[0][0]),
                    next_idx=out_idx + 1,
                    input=fixed.to_m31(flat.reshape(-1)),
                    out=out_col,
                )
                cols[extra_names[0]] = fixed.to_m31(acc.reshape(-1))
                cols[extra_names[1]] = fixed.to_m31(nxt.reshape(-1))
                if op == "max_reduce":
                    cols["is_max"] = is_max
                    cols["ge_limb0"] = ge_u32 & 0xFF
                    cols["ge_limb1"] = (ge_u32 >> 8) & 0xFF
                    cols["ge_limb2"] = (ge_u32 >> 16) & 0xFF
                    cols["ge_limb3"] = (ge_u32 >> 24) & 0x3F
                    cols["range_check_mult"] = np.uint32(1)
                    if rc_mults is not None:
                        for limb in (
                            cols["ge_limb0"],
                            cols["ge_limb1"],
                            cols["ge_limb2"],
                            cols["ge_limb3"] * 4,
                        ):
                            rc_mults += np.bincount(limb, minlength=len(rc_mults))
                cols["is_last_step"] = is_last_step
                cols["input_mult"] = NEG1
                cols["out_mult"] = (is_last_step * om).astype(np.uint32)
                tables[op].append(**cols)
                op_counter[op] += 1
        else:
            raise LuminairError(f"unknown op {op}")

    # outputs: key by the retrieved node and by the pre-compile producer id
    # the user's GraphTensor still holds.
    graph.output_data = {}
    for rid in graph.to_retrieve:
        node = graph.nodes[rid]
        data = fixed.to_float(buffers[rid])
        graph.output_data[rid] = data
        if node.op == "copy_from":
            src = node.srcs[0][0]
            graph.output_data[src] = data
            if graph.nodes[src].op == "copy_to":
                graph.output_data[graph.nodes[src].srcs[0][0]] = data

    return tables, op_counter, ranges, range_check_needed, lut_mults, rc_mults


def execute(graph: Graph):
    """Plain fixed-point execution (no trace)."""
    _run(graph, record_trace=False, settings=None, collect_ranges=False)


def gen_circuit_settings_host(graph: Graph) -> CircuitSettings:
    """Pre-execute the graph on the host to discover LUT value ranges."""
    if not graph.compiled:
        graph.compile()
    _, _, ranges, rc, _, _ = _run(
        graph, record_trace=False, settings=None, collect_ranges=True
    )
    return settings_from_ranges(ranges, rc)


def gen_trace_host(graph: Graph, settings: CircuitSettings) -> LuminairPie:
    """Execute and capture all trace tables on the host (numpy columns)."""
    if not graph.compiled:
        graph.compile()
    tables, op_counter, _, _, lut_mults, rc_mults = _run(
        graph, record_trace=True, settings=settings, collect_ranges=False
    )
    trace_tables = {}
    for name, tb in tables.items():
        t = tb.build(name)
        if t is not None:
            trace_tables[name] = t
    # LUT multiplicity tables.
    for kind, mults in lut_mults.items():
        trace_tables[f"{kind}_lookup"] = TraceTable(
            f"{kind}_lookup", {"multiplicity": mults.astype(np.uint32)}
        )
    if rc_mults is not None:
        trace_tables["range_check_lookup"] = TraceTable(
            "range_check_lookup", {"multiplicity": rc_mults.astype(np.uint32)}
        )
    max_log = max(t.log_size for t in trace_tables.values())
    return LuminairPie(
        trace_tables=trace_tables,
        metadata=Metadata(ExecutionResources(dict(op_counter), max_log)),
    )


def gen_circuit_settings(graph: Graph, device=None) -> CircuitSettings:
    """Discover the LUT value ranges on `device` (the current CUDA device
    when None; raises ProverError without one)."""
    from ..prover import resolve_device
    from .device_trace import gen_circuit_settings_device

    return gen_circuit_settings_device(graph, resolve_device(device))


def gen_trace(graph: Graph, settings: CircuitSettings, device=None) -> LuminairPie:
    """Execute the graph on `device` (the current CUDA device when None;
    raises ProverError without one) with every trace column born there,
    padded; prove() on the same device reads the columns where they lie."""
    from ..prover import resolve_device
    from .device_trace import gen_trace_device

    return gen_trace_device(graph, settings, resolve_device(device))
