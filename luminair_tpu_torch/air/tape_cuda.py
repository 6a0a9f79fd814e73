"""The check tapes as CUDA source: each component's trace-domain check
(`tape.record(comp)`) written out as straight-line code, the header
csrc/check_tapes.cuh that the check kernel (csrc/check.cuh) compiles.

A tape register becomes a local of the same number, an instruction one
statement, a column a compile-time index into the component's column
table (CheckRow: main columns, preprocessed columns, the 4E interaction
coordinates, is_first); so the compiled check has no interpreter loop, no
`switch` on opcodes and no register array.  The header is committed and
compiled like every kernel source; regenerate it after a component's
`evaluate` changes:

    python3 -m luminair_tpu_torch.air.tape_cuda

tests/test_torch_check_tapes.py fails while the committed header differs
from `generate()`, and `kernels.air_check` refuses a tape whose digest (its
shape and words) is not in the header's manifest.
"""

from __future__ import annotations

from pathlib import Path
from typing import List

from .. import kernels
from . import tape
from .components import ALL_COMPONENTS

HEADER = Path(kernels.__file__).resolve().parent / "csrc" / kernels.CHECK_TAPES_HEADER

_BINARY = {tape.OP_ADD: "add", tape.OP_SUB: "sub", tape.OP_MUL: "mul"}


def tape_function(tp: tape.Tape) -> List[str]:
    """One component's check as a device function of a CheckRow."""
    inter0 = tp.n_main + tp.n_pp
    first = inter0 + 4 * tp.n_relations
    regs = ", ".join(f"r{i} = 0u" for i in range(tp.n_regs))
    body = [f"  uint32_t {regs};", "  uint32_t w = 0u;", "  qm31 s = {0u, 0u, 0u, 0u};  // S_{b-1}"]
    k = b = 0
    for op, dst, a, x, y in tp.instructions():
        if op == tape.OP_MAIN:
            body.append(f"  r{dst} = q.at({a});")
        elif op == tape.OP_MAIN_NEXT:
            body.append(f"  r{dst} = q.next({a});")
        elif op == tape.OP_PP:
            body.append(f"  r{dst} = q.at({tp.n_main + a});")
        elif op == tape.OP_CONST:
            body.append(f"  r{dst} = {a}u;")
        elif op in _BINARY:
            body.append(f"  r{dst} = {_BINARY[op]}(r{a}, r{x});")
        elif op == tape.OP_NEG:
            body.append(f"  r{dst} = neg(r{a});")
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
            raise tape.TapeError(f"{tp.name}: bad opcode {op}")
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


def write() -> None:
    HEADER.write_text(generate())


if __name__ == "__main__":
    write()
