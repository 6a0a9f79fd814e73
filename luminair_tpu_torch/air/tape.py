"""Components as straight-line programs: the recorder, the tape format and
its plain PyTorch interpreter.

A component writes its constraints once (`evaluate(ev, elems)`,
air/components.py).  `record(comp)` runs that once with symbolic values and
keeps what it did as a tape: an int32 program that air/tape_cuda.py
writes out as straight-line CUDA for the witness, domain and check kernels
(csrc/air_tapes.cuh, csrc/check_tapes.cuh; one thread a row), and that
`witness_plain` / `domain_plain` / `check_plain` here interpret
column-wise for CPU tensors.  Both read the same instructions, so there is
one definition of each component and one format.

Every constraint and every relation input is an M31 expression of main and
preprocessed columns and integer constants (reduced mod P when recorded:
2^31 - 1 becomes 0, as `fields.qm31_from_ints` makes it).  Only the LogUp
part is QM31, and it has a fixed shape that the interpreters hard-code: per
relation entry b with multiplicity n_b and values v,
    d_b = v_0 + alpha * v_1 - z          (the entry's lookup elements)
    S_b = S_{b-1} + n_b / d_b            (within the row)
and the last column also carries the running sum down the rows.  The domain
and check interpreters add, after the K recorded constraints, one LogUp
constraint per entry (air/framework.py `_finalize_logup`), so a component
uses K + E powers of the composition's alpha, and K + E bits of a check
word.

Instructions are 5 words [op, dst, a, b, c]:
    MAIN        dst <- main column a (this row)
    MAIN_NEXT   dst <- main column a at the next row (cyclic)
    PP          dst <- preprocessed column a
    CONST       dst <- a
    ADD/SUB/MUL dst <- a op b
    NEG         dst <- -a
    CONSTRAINT  register a must vanish
    RELATION    entry with lookup elements of kind `dst`, multiplicity a,
                values b and c (c = -1 for a one-value relation)
Registers are allocated after recording (dead values dropped, loads moved
to their first use, a register reused once its value is dead), so the
widest tape needs few of them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence

import torch

from .. import circle
from .. import fields as f
# The kernels' ABI: element kinds in table order, and the limits `record` checks.
from ..kernels import ELEM_KINDS
from ..kernels import TAPE_MAX_MAIN as MAX_MAIN, TAPE_MAX_POWS as MAX_POWS
from ..kernels import TAPE_MAX_PP as MAX_PP, TAPE_MAX_REGS as MAX_REGS, TAPE_MAX_RELATIONS as MAX_RELATIONS
from .framework import AirEval

OP_MAIN, OP_MAIN_NEXT, OP_PP, OP_CONST, OP_ADD, OP_SUB, OP_MUL, OP_NEG, OP_CONSTRAINT, OP_RELATION = range(10)
INS_WORDS = 5
_LEAVES = (OP_MAIN, OP_MAIN_NEXT, OP_PP, OP_CONST)
_BINARY = (OP_ADD, OP_SUB, OP_MUL)


class TapeError(ValueError):
    pass


class Sym:
    """A recorded M31 value: an SSA id in its recorder's program."""

    __slots__ = ("ev", "id")

    def __init__(self, ev: "TapeEval", id_: int):
        self.ev = ev
        self.id = id_

    def _val(self, other) -> int:
        if isinstance(other, Sym):
            return other.id
        if isinstance(other, int):
            return self.ev._emit(OP_CONST, other % f.P)
        raise TapeError(f"cannot record an operand of type {type(other).__name__}")

    def __add__(self, other):
        return Sym(self.ev, self.ev._emit(OP_ADD, self.id, self._val(other)))

    __radd__ = __add__

    def __sub__(self, other):
        return Sym(self.ev, self.ev._emit(OP_SUB, self.id, self._val(other)))

    def __rsub__(self, other):
        return Sym(self.ev, self.ev._emit(OP_SUB, self._val(other), self.id))

    def __mul__(self, other):
        return Sym(self.ev, self.ev._emit(OP_MUL, self.id, self._val(other)))

    __rmul__ = __mul__

    def __neg__(self):
        return Sym(self.ev, self.ev._emit(OP_NEG, self.id))


class _Elements:
    """Stands in for a LookupElements while recording."""

    def __init__(self, kind: str):
        self.kind = ELEM_KINDS.index(kind)


class TapeEval(AirEval):
    """Runs `comp.evaluate` once with symbolic values."""

    def __init__(self, comp):
        super().__init__("cpu")
        self.comp = comp
        self.ins: List[list] = []  # SSA: [op, a, b, c]; the value id is the index

    def _emit(self, op: int, a: int = 0, b: int = 0, c: int = 0) -> int:
        self.ins.append([op, a, b, c])
        return len(self.ins) - 1

    def main(self, name: str) -> Sym:
        return Sym(self, self._emit(OP_MAIN, self.comp.MAIN.index(name)))

    def main_next(self, name: str) -> Sym:
        if name not in self.comp.MAIN_NEXT:
            raise TapeError(f"{self.comp.name}: {name} is read at the next row but not in MAIN_NEXT")
        return Sym(self, self._emit(OP_MAIN_NEXT, self.comp.MAIN.index(name)))

    def preprocessed(self, pp_id: str) -> Sym:
        return Sym(self, self._emit(OP_PP, list(self.comp.PP_IDS).index(pp_id)))

    def one(self) -> Sym:
        return self.const(1)

    def const(self, x: int) -> Sym:
        return Sym(self, self._emit(OP_CONST, x % f.P))

    def constraint(self, expr: Sym):
        self._emit(OP_CONSTRAINT, expr.id)

    def relation(self, elements: _Elements, mult: Sym, values: List[Sym]):
        if not 1 <= len(values) <= 2:
            raise TapeError(f"{self.comp.name}: relation of {len(values)} values")
        v = [mult._val(x) for x in values] + [-1]
        self._emit(OP_RELATION, mult.id, v[0], v[1])
        self.ins[-1].append(elements.kind)

    def finalize_logup(self):
        pass  # the LogUp constraints have a fixed shape: the interpreters add them


@dataclass
class Tape:
    name: str
    words: List[int]  # n_ins * INS_WORDS
    n_regs: int
    n_constraints: int  # K
    n_relations: int  # E
    n_main: int
    n_pp: int

    @property
    def n_ins(self) -> int:
        return len(self.words) // INS_WORDS

    @property
    def n_pows(self) -> int:
        return self.n_constraints + self.n_relations

    @property
    def next_cols(self) -> List[int]:
        """The main columns the tape reads at the next row (MAIN_NEXT)."""
        return sorted({a for op, _, a, _, _ in self.instructions() if op == OP_MAIN_NEXT})

    def instructions(self):
        for i in range(0, len(self.words), INS_WORDS):
            yield self.words[i : i + INS_WORDS]


def _operands(ins) -> List[int]:
    op, a, b, c = ins[:4]
    if op in _BINARY:
        return [a, b]
    if op in (OP_NEG, OP_CONSTRAINT):
        return [a]
    if op == OP_RELATION:
        return [x for x in (a, b, c) if x >= 0]
    return []


def _compile(comp, ssa: List[list], witness: bool) -> Tape:
    # Dead values out: only relations (and constraints, unless the program
    # is for the witness) are kept for their own sake.
    roots = (OP_RELATION,) if witness else (OP_CONSTRAINT, OP_RELATION)
    live = set()
    for i in range(len(ssa) - 1, -1, -1):
        if ssa[i][0] in roots or i in live:
            live.add(i)
            live.update(_operands(ssa[i]))
    # Leaves (loads, constants) move to just before their first use.
    order, placed = [], set()
    for i, ins in enumerate(ssa):
        if i not in live or ins[0] in _LEAVES:
            continue
        for o in _operands(ins):
            if ssa[o][0] in _LEAVES and o not in placed:
                order.append(o)
                placed.add(o)
        order.append(i)
    last_use = {}
    for pos, i in enumerate(order):
        for o in _operands(ssa[i]):
            last_use[o] = pos
    # Register allocation: operands are read before the result is written,
    # so a register freed by this instruction may take its result.
    reg, free, n_regs, words = {}, [], 0, []
    n_constraints = n_relations = 0
    for pos, i in enumerate(order):
        ins = ssa[i]
        op = ins[0]
        srcs = [reg[o] for o in _operands(ins)]
        for o in set(_operands(ins)):
            if last_use[o] == pos:
                free.append(reg[o])
        if op == OP_CONSTRAINT:
            words += [op, 0, srcs[0], 0, 0]
            n_constraints += 1
            continue
        if op == OP_RELATION:
            words += [op, ins[4], srcs[0], srcs[1], srcs[2] if len(srcs) > 2 else -1]
            n_relations += 1
            continue
        if free:
            free.sort()
            dst = free.pop(0)
        else:
            dst, n_regs = n_regs, n_regs + 1
        reg[i] = dst
        if op in _LEAVES:
            words += [op, dst, ins[1], 0, 0]
        else:
            words += [op, dst] + srcs + [0] * (3 - len(srcs))
    tape = Tape(comp.name, words, n_regs, n_constraints, n_relations, len(comp.MAIN), len(list(comp.PP_IDS)))
    limits = [
        (tape.n_regs, MAX_REGS, "registers"),
        (tape.n_main, MAX_MAIN, "main columns"),
        (tape.n_pp, MAX_PP, "preprocessed columns"),
        (tape.n_relations, MAX_RELATIONS, "relation entries"),
        (tape.n_pows, MAX_POWS, "constraints"),
    ]
    for n, cap, what in limits:
        if n > cap:
            raise TapeError(f"{comp.name}: {n} {what}, the kernels take at most {cap}")
    if tape.n_relations == 0:
        raise TapeError(f"{comp.name}: no relation entry")
    return tape


_TAPES: Dict[tuple, Tape] = {}


def record(comp, witness: bool = False) -> Tape:
    """The component's tape, recorded once per component.  The witness
    tape leaves the constraints out (K = 0): the interaction needs only
    the relation entries."""
    key = (comp.name, witness)
    if key not in _TAPES:
        ev = TapeEval(comp)
        comp.evaluate(ev, {k: _Elements(k) for k in ELEM_KINDS})
        _TAPES[key] = _compile(comp, ev.ins, witness)
    return _TAPES[key]


def element_words(elems) -> List[List[tuple]]:
    """[kind][z, alpha] QM31 words of the drawn lookup elements, zeros for
    kinds the claim has not drawn."""
    out = []
    for kind in ELEM_KINDS:
        e = elems.get(kind)
        out.append([f.qm31_words(e.z), f.qm31_words(e.alpha)] if e is not None else [(0,) * 4] * 2)
    return out


# ---------------------------------------------------------------------------
# The plain interpreter: whole columns, int64 field arithmetic.


def _after(col: torch.Tensor, stride: int, nxt) -> torch.Tensor:
    """Each row's value `stride` rows later: past the end, the halo `nxt`
    (the rows after the block), or the column's own first rows (cyclic)."""
    return torch.roll(col, -stride, 0) if nxt is None else torch.cat([col[stride:], nxt])


def _before(col: torch.Tensor, stride: int, prev) -> torch.Tensor:
    """Each row's value `stride` rows earlier: the halo `prev` (the rows
    before the block) or the column's own last rows (cyclic)."""
    return torch.roll(col, stride, 0) if prev is None else torch.cat([prev, col[:-stride]])


def _run(tape: Tape, main, pp, rows: int, next_roll: int, on_relation, on_constraint, dev, nxt=None):
    regs = [None] * tape.n_regs
    nxt = nxt or {}
    for op, dst, a, b, c in tape.instructions():
        if op == OP_MAIN:
            regs[dst] = main[a].to(f.I64)
        elif op == OP_MAIN_NEXT:
            regs[dst] = _after(main[a], next_roll, nxt.get(a)).to(f.I64)
        elif op == OP_PP:
            regs[dst] = pp[a].to(f.I64)
        elif op == OP_CONST:
            regs[dst] = torch.full((rows,), a, dtype=f.I64, device=dev)
        elif op == OP_ADD:
            regs[dst] = f.add(regs[a], regs[b])
        elif op == OP_SUB:
            regs[dst] = f.sub(regs[a], regs[b])
        elif op == OP_MUL:
            regs[dst] = f.mul(regs[a], regs[b])
        elif op == OP_NEG:
            regs[dst] = f.neg(regs[a])
        elif op == OP_CONSTRAINT:
            on_constraint(regs[a])
        elif op == OP_RELATION:
            on_relation(dst, regs[a], regs[b], regs[c] if c >= 0 else None)
        else:
            raise TapeError(f"bad opcode {op}")


def _denominator(ew, kind, v0, v1, dev):
    z, alpha = (torch.tensor(w, dtype=f.I64, device=dev) for w in ew[kind])
    d = f.sub(f.qm31_from_m31(v0), z)
    return d if v1 is None else f.add(d, f.qm31_mul_m31(alpha, v1))


def witness_plain(tape: Tape, main: Sequence[torch.Tensor], pp: Sequence[torch.Tensor], ew, carry=None):
    """(interaction columns (4E, N) int32 -- row 4b + k is coordinate k of
    entry b --, claimed sum (4,) int32).  With `carry` (4 words), the rows
    are a block of a larger trace: the last entry's running sum starts
    from the carry, the sum of the blocks before it, and the claimed sum
    is the block's last row."""
    ref = (list(main) + list(pp))[0]
    n, dev = ref.shape[0], ref.device
    cols = []
    row_acc = f.qm31_zero((n,), dev)

    def on_relation(kind, mult, v0, v1):
        nonlocal row_acc
        d = _denominator(ew, kind, v0, v1, dev)
        row_acc = f.add(row_acc, f.qm31_mul_m31(f.qm31_inv(d), mult))
        cols.append(row_acc.t())

    _run(tape, main, pp, n, 1, on_relation, lambda _: None, dev)
    # The last column's running sum down the rows; partial sums stay below
    # 2^31 * rows, inside int64.
    cols[-1] = torch.cumsum(cols[-1], dim=1) % f.P
    if carry is not None:
        cols[-1] = f.add(cols[-1], torch.tensor(f.qm31_words(carry), dtype=f.I64, device=dev)[:, None])
    out = torch.cat(cols).to(f.I32)
    return out, out[-4:, -1].clone()


def _logup(tape: Tape, inter, is_first, claimed, ew, stride: int, emit, prev=None):
    """`on_relation` for `_run` that calls emit(c, K + b) with entry b's
    LogUp constraint c (M, 4) int64:
        (S_b - S_{b-1} [- S_last(r - stride) + is_first * claimed]) * d_b - n_b
    (S_{-1} = 0; the bracket on the last entry only)."""
    dev = is_first.device
    state = {"b": 0, "prev": None}

    def on_relation(kind, mult, v0, v1):
        b = state["b"]
        d = _denominator(ew, kind, v0, v1, dev)
        s = torch.stack([inter[4 * b + k] for k in range(4)], dim=-1).to(f.I64)
        diff = s if state["prev"] is None else f.sub(s, state["prev"])
        if b == tape.n_relations - 1:
            s_prev = _before(s, stride, None if prev is None else torch.stack(list(prev), dim=-1).to(f.I64))
            cl = torch.tensor(claimed, dtype=f.I64, device=dev)
            diff = f.add(f.sub(diff, s_prev), f.qm31_mul_m31(cl, is_first.to(f.I64)))
        emit(f.sub(f.qm31_mul(diff, d), f.qm31_from_m31(mult)), tape.n_constraints + b)
        state["prev"] = s
        state["b"] += 1

    return on_relation


def check_plain(tape: Tape, main, pp, inter, is_first, claimed, ew) -> torch.Tensor:
    """The constraint check on the trace domain (N = 2^n rows): (N,) int32,
    bit i of row r set when constraint i is nonzero at r -- the K recorded
    constraints, then the E LogUp constraints (a QM31 one when any
    coordinate is).  Next row r + 1, the last entry's previous row r - 1
    (cyclic); no alpha powers, no vanishing factor."""
    n = is_first.shape[0]
    dev = is_first.device
    mask = torch.zeros(n, dtype=f.I64, device=dev)
    state = {"k": 0}

    def set_bit(c, i):
        nonzero = (c != 0).any(dim=-1) if c.dim() == 2 else c != 0
        mask.bitwise_or_(nonzero.to(f.I64) << i)

    def on_constraint(v):
        set_bit(v, state["k"])
        state["k"] += 1

    _run(tape, main, pp, n, 1, _logup(tape, inter, is_first, claimed, ew, 1, set_bit), on_constraint, dev)
    return f.to_i32(mask)


def domain_plain(tape: Tape, main, pp, inter, is_first, claimed, ew, pows, log_trace: int, stride: int,
                 acc=None, row0: int = 0, log_domain=None, halo=None):
    """Quotient evaluations (M, 4) int32 of one component on its commit
    domain D_log (M = 2^log): sum_i pows[i] * C_i over the K recorded and E
    LogUp constraints (pows: the K + E alpha powers that fall to this
    component), times 1 / V_n(x) of the row.  The next row is a roll
    by `stride`; the last interaction column's previous row the opposite
    roll.  With `acc`, returns acc + that.

    A row block: rows [row0, row0 + M) of D_log_domain, halo = (next
    {main index: (stride,)}, prev (4 coordinates, (stride,) each)) the
    rows after and before the block in place of the rolls' wrap."""
    m = is_first.shape[0]
    dev = is_first.device
    log = m.bit_length() - 1 if log_domain is None else log_domain
    nxt, prev = halo if halo is not None else (None, None)
    pw = torch.tensor(pows, dtype=f.I64, device=dev).reshape(-1, 4)
    total = f.qm31_zero((m,), dev)
    state = {"k": 0}

    def add(c, i):
        nonlocal total
        total = f.add(total, f.qm31_mul(c, pw[i]) if c.dim() == 2 else f.qm31_mul_m31(pw[i], c))

    def on_constraint(v):
        add(v, state["k"])
        state["k"] += 1

    on_relation = _logup(tape, inter, is_first, claimed, ew, stride, add, prev)
    _run(tape, main, pp, m, stride, on_relation, on_constraint, dev, nxt)
    xs = circle.domain_table(log, dev)[0][row0 : row0 + m].to(f.I64)
    q = f.qm31_mul_m31(total, f.inv(circle.coset_vanishing_eval(xs, log_trace)))
    if acc is not None:
        q = f.add(acc.to(f.I64), q)
    return q.to(f.I32)
