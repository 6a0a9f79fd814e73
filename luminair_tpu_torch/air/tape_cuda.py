"""The component tapes as CUDA source, each written out as straight-line
code: the trace-domain check (`tape.record(comp)`) into the header
csrc/check_tapes.cuh that the check kernel (csrc/check.cuh) compiles, and
K5's witness (`tape.record(comp, witness=True)`) and K6's quotient terms
(`tape.record(comp)`) into csrc/air_tapes.cuh, which K5 and K6
(csrc/air.cuh) compile.

A tape register becomes a local of the same number, an instruction one
statement, a column a compile-time index into the component's column
table (tape_row.cuh's TapeRow: main columns, preprocessed columns, the 4E
interaction coordinates, is_first, then K6's halo columns); so the
compiled code has no interpreter loop, no `switch` on opcodes and no
register array.  The headers are committed and compiled like every kernel
source; regenerate them after a component's `evaluate` changes:

    python3 -m luminair_tpu_torch.air.tape_cuda

tests/test_torch_check_tapes.py and tests/test_torch_air_tapes.py fail
while a committed header differs from `generate()` / `generate_air()`,
and `kernels.air_check`, `air_witness_many` and `air_domain_many` refuse a
tape whose digest (its shape and words) is not in the header's manifest.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional

from .. import kernels
from . import tape
from .components import ALL_COMPONENTS

HEADER = Path(kernels.__file__).resolve().parent / "csrc" / kernels.CHECK_TAPES_HEADER
AIR_HEADER = HEADER.with_name(kernels.AIR_TAPES_HEADER)

_BINARY = {tape.OP_ADD: "add", tape.OP_SUB: "sub", tape.OP_MUL: "mul"}


def tape_function(tp: tape.Tape) -> List[str]:
    """One component's check as a device function of a CheckRow."""
    inter0 = tp.n_main + tp.n_pp
    first = inter0 + 4 * tp.n_relations
    regs = ", ".join(f"r{i} = 0u" for i in range(tp.n_regs))
    body = [f"  uint32_t {regs};", "  uint32_t w = 0u;", "  qm31 s = {0u, 0u, 0u, 0u};  // S_{b-1}"]
    k = b = 0
    for op, dst, a, x, y in tp.instructions():
        line = _arith(op, dst, a, x)
        if line is not None:
            body.append(line)
        elif op == tape.OP_CONSTRAINT:
            body.append(f"  w |= nonzero(r{a}) << {k};")
            k += 1
        elif op == tape.OP_RELATION:
            two = y >= 0
            last = first if b == tp.n_relations - 1 else -1
            v1 = f"r{y}" if two else "0u"
            body.append(f"  w |= q.logup<{inter0 + 4 * b}, {dst}, {str(two).lower()}, {last}>(s, r{a}, r{x}, {v1})"
                        f" << {tp.n_constraints + b};")
            b += 1
        else:
            body.append(_leaf(tp, op, dst, a, lambda col: f"q.next({col})"))
    head = (f"// {tp.name}: {tp.n_ins} instructions, {tp.n_regs} registers, K = {tp.n_constraints}, "
            f"E = {tp.n_relations}, {tp.n_main} main, {tp.n_pp} preprocessed columns")
    return [head, f"__host__ __device__ __forceinline__ uint32_t check_tape_{tp.name}(const CheckRow& q) {{",
            *body, "  return w;", "}"]


def generate() -> str:
    """The header's text: every component's compiled check, in
    ALL_COMPONENTS order (the kind is the index)."""
    tapes = [tape.record(c) for c in ALL_COMPONENTS]
    out = [
        "// Generated by luminair_tpu_torch/air/tape_cuda.py from the components' check",
        "// tapes (air/tape.py `record`); do not edit.  Regenerate with",
        "//     python3 -m luminair_tpu_torch.air.tape_cuda",
        "// tests/test_torch_check_tapes.py fails while this file and the tapes differ.",
        "//",
        "// Each function is one component's check tape as straight-line code (see",
        "// check.cuh): it returns the row's word, bit k for the k-th recorded",
        "// constraint, bit K + b for relation entry b's LogUp constraint.",
        "//",
        "// The manifest, `tape <kind> <component> <sha256 of the tape's shape and words>`",
        "// (kernels.tape_digest; kernels.compiled_check_tapes reads it):",
        *(f"// tape {i} {tp.name} {kernels.tape_digest(tp)}" for i, tp in enumerate(tapes)),
        "#pragma once",
        "",
        "namespace lum {",
        "",
    ]
    for tp in tapes:
        out += tape_function(tp) + [""]
    out += [
        f"constexpr int CHECK_KINDS = {len(tapes)};",
        "",
        "}  // namespace lum",
        "",
        "// X(kind, component) of every compiled tape.",
        "#define LUM_CHECK_TAPES(X) \\",
        " \\\n".join(f"  X({i}, {tp.name})" for i, tp in enumerate(tapes)),
        "",
    ]
    return "\n".join(out)


def _leaf(tp: tape.Tape, op: int, dst: int, a: int, next_row=None) -> str:
    """The statement of a load or a constant; next_row(column) gives the
    expression of a main column's next row."""
    if op == tape.OP_MAIN:
        return f"  r{dst} = q.at({a});"
    if op == tape.OP_MAIN_NEXT:
        if next_row is None:
            raise tape.TapeError(f"{tp.name}: a witness tape reads no next row")
        return f"  r{dst} = {next_row(a)};"
    if op == tape.OP_PP:
        return f"  r{dst} = q.at({tp.n_main + a});"
    if op == tape.OP_CONST:
        return f"  r{dst} = {a}u;"
    raise tape.TapeError(f"{tp.name}: bad opcode {op}")


def _arith(op: int, dst: int, a: int, x: int) -> Optional[str]:
    """The statement of M31 arithmetic, None for any other instruction."""
    if op in _BINARY:
        return f"  r{dst} = {_BINARY[op]}(r{a}, r{x});"
    if op == tape.OP_NEG:
        return f"  r{dst} = neg(r{a});"
    return None


def witness_function(tp: tape.Tape) -> List[str]:
    """One component's K5 row as a device function of a TapeRow: each
    entry's multiplicity and denominator, then `witness_sums` (air.cuh)
    writes the first E - 1 entries' sums and returns the row total."""
    if tp.n_constraints:
        raise tape.TapeError(f"{tp.name}: a witness tape has no recorded constraint")
    regs = ", ".join(f"r{i} = 0u" for i in range(tp.n_regs))
    E = tp.n_relations
    body = [f"  uint32_t {regs};", f"  uint32_t m[{E}];", f"  qm31 d[{E}];"]
    b = 0
    for op, dst, a, x, y in tp.instructions():
        line = _arith(op, dst, a, x)
        if line is not None:
            body.append(line)
        elif op == tape.OP_RELATION:
            two = y >= 0
            v1 = f"r{y}" if two else "0u"
            body += [f"  m[{b}] = r{a};", f"  d[{b}] = q.denom<{dst}, {str(two).lower()}>(r{x}, {v1});"]
            b += 1
        else:
            body.append(_leaf(tp, op, dst, a))
    head = (f"// {tp.name}: {tp.n_ins} instructions, {tp.n_regs} registers, E = {E}, {tp.n_main} main, "
            f"{tp.n_pp} preprocessed columns")
    return [head, f"__host__ __device__ __forceinline__ qm31 witness_tape_{tp.name}(const TapeRow<false>& q, "
            "uint32_t* out, long long n) {",
            *body, f"  return witness_sums<{E}>(m, d, out, n, q.r);", "}"]


def domain_function(tp: tape.Tape) -> List[str]:
    """One component's K6 terms at a row as a device function of a
    TapeRow with halos: sum_i pw[i] * C_i over its K recorded constraints
    and E LogUp constraints (before the division by V_n).  Its halo
    columns follow is_first: one per main column read at the next row (in
    `next_cols` order), then the last entry's 4 coordinates."""
    inter0 = tp.n_main + tp.n_pp
    first = inter0 + 4 * tp.n_relations
    halo = first + 1
    nexts = tp.next_cols
    prev = halo + len(nexts)
    regs = ", ".join(f"r{i} = 0u" for i in range(tp.n_regs))
    body = [f"  uint32_t {regs};", "  qm31 acc = {0u, 0u, 0u, 0u};", "  qm31 s = {0u, 0u, 0u, 0u};  // S_{b-1}"]
    k = b = 0
    for op, dst, a, x, y in tp.instructions():
        line = _arith(op, dst, a, x)
        if line is not None:
            body.append(line)
        elif op == tape.OP_CONSTRAINT:
            body.append(f"  acc = qadd(acc, qmul_m31(qload(pw[{k}]), r{a}));")
            k += 1
        elif op == tape.OP_RELATION:
            two = y >= 0
            last = b == tp.n_relations - 1
            v1 = f"r{y}" if two else "0u"
            args = f"{inter0 + 4 * b}, {dst}, {str(two).lower()}, {first if last else -1}, {prev if last else -1}"
            body.append(f"  acc = qadd(acc, qmul(q.logup_value<{args}>(s, r{a}, r{x}, {v1}), "
                        f"qload(pw[{tp.n_constraints + b}])));")
            b += 1
        else:
            body.append(_leaf(tp, op, dst, a, lambda col: f"q.next({col}, {halo + nexts.index(col)})"))
    head = (f"// {tp.name}: {tp.n_ins} instructions, {tp.n_regs} registers, K = {tp.n_constraints}, "
            f"E = {tp.n_relations}, {tp.n_main} main, {tp.n_pp} preprocessed columns, "
            f"{len(nexts)} read at the next row")
    return [head, f"__host__ __device__ __forceinline__ qm31 domain_tape_{tp.name}(const TapeRow<true>& q, "
            "const uint32_t (*pw)[4]) {", *body, "  return acc;", "}"]


def generate_air() -> str:
    """csrc/air_tapes.cuh's text: every component's K5 and K6 functions,
    in ALL_COMPONENTS order (the kind is the index)."""
    witness = [tape.record(c, witness=True) for c in ALL_COMPONENTS]
    domain = [tape.record(c) for c in ALL_COMPONENTS]
    out = [
        "// Generated by luminair_tpu_torch/air/tape_cuda.py from the components' witness",
        "// and domain tapes (air/tape.py `record`); do not edit.  Regenerate with",
        "//     python3 -m luminair_tpu_torch.air.tape_cuda",
        "// tests/test_torch_air_tapes.py fails while this file and the tapes differ.",
        "//",
        "// witness_tape_<component>: one row of K5 (see air.cuh), its entries' sums",
        "// written but the last, the row total returned.  domain_tape_<component>: one",
        "// row of K6's terms, sum_i pw[i] * C_i over the K recorded and E LogUp",
        "// constraints, before the division by V_n.",
        "//",
        "// The manifest, `<witness|domain> <kind> <component> <sha256 of the tape's shape",
        "// and words>` (kernels.tape_digest; kernels.compiled_air_tapes reads it):",
        *(f"// witness {i} {tp.name} {kernels.tape_digest(tp)}" for i, tp in enumerate(witness)),
        *(f"// domain {i} {tp.name} {kernels.tape_digest(tp)}" for i, tp in enumerate(domain)),
        "#pragma once",
        "",
        "namespace lum {",
        "",
    ]
    for tp in witness:
        out += witness_function(tp) + [""]
    for tp in domain:
        out += domain_function(tp) + [""]
    out += [
        f"constexpr int AIR_KINDS = {len(domain)};",
        "",
        "}  // namespace lum",
        "",
        "// X(kind, component) of every compiled component.",
        "#define LUM_AIR_TAPES(X) \\",
        " \\\n".join(f"  X({i}, {tp.name})" for i, tp in enumerate(domain)),
        "",
    ]
    return "\n".join(out)


def write() -> None:
    HEADER.write_text(generate())
    AIR_HEADER.write_text(generate_air())


if __name__ == "__main__":
    write()
