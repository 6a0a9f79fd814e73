"""The 17 AIR components: 13 operator components + 4 lookup-table
components.

Column sets and constraint systems mirror the reference exactly
(crates/air/src/components/<op>/{table,component}.rs; see SURVEY.md section
2.2 for the per-op inventory).  Each component defines `evaluate(ev,
elems)` once; the framework (air/framework.py) interprets it for witness
generation, prover constraint evaluation, and verifier point evaluation.

Fixed-point constraint identities (numerair-equivalent -- see fixed.py):
  add:   lhs + rhs - out
  mul:   lhs*rhs - out*2^S - rem
  recip: input*out + rem - 2^2S            (scale is a trace column)
  sqrt:  out^2 + rem - input*scale
  rem:   quotient*rhs + rem - lhs
"""

from __future__ import annotations

from typing import Dict, List

from . import framework as fw
from ..fixed import DEFAULT_FP_SCALE

SCALE = 1 << DEFAULT_FP_SCALE
M31_MAX = (1 << 31) - 1


class Component:
    name: str = ""
    MAIN: List[str] = []
    #: relation entry count == number of interaction (secure) columns
    N_INTERACTION: int = 0
    #: preprocessed ids used (besides the framework-provided is_first)
    PP_IDS: List[str] = []
    #: main columns read at the NEXT row via ev.main_next (the verifier
    #: samples these at z + G_n as well as z)
    MAIN_NEXT: List[str] = []

    def evaluate(self, ev: fw.AirEval, elems: Dict[str, fw.LookupElements]):
        raise NotImplementedError


def _transitions(ev, c, id_cols):
    """Shared transition constraints: outside the last index of an op's
    tensor, the next row continues the same node with idx+1
    (reference add/component.rs:80-96)."""
    not_last = ev.one() - c["is_last_idx"]
    for a, b in id_cols:
        ev.constraint(not_last * (c[a] - c[b]))
    ev.constraint(not_last * (c["next_idx"] - c["idx"] - 1))


class AddComponent(Component):
    name = "add"
    MAIN = "node_id lhs_id rhs_id idx is_last_idx next_node_id next_lhs_id next_rhs_id next_idx lhs rhs out lhs_mult rhs_mult out_mult".split()
    N_INTERACTION = 3

    def evaluate(self, ev, elems):
        c = {n: ev.main(n) for n in self.MAIN}
        ev.constraint(c["is_last_idx"] * (c["is_last_idx"] - 1))
        ev.constraint(c["lhs"] + c["rhs"] - c["out"])
        _transitions(ev, c, [("next_node_id", "node_id"), ("next_lhs_id", "lhs_id"), ("next_rhs_id", "rhs_id")])
        node = elems["node"]
        ev.relation(node, c["lhs_mult"], [c["lhs"], c["lhs_id"]])
        ev.relation(node, c["rhs_mult"], [c["rhs"], c["rhs_id"]])
        ev.relation(node, c["out_mult"], [c["out"], c["node_id"]])
        ev.finalize_logup()


class MulComponent(Component):
    name = "mul"
    MAIN = "node_id lhs_id rhs_id idx is_last_idx next_node_id next_lhs_id next_rhs_id next_idx lhs rhs out rem lhs_mult rhs_mult out_mult".split()
    N_INTERACTION = 3

    def evaluate(self, ev, elems):
        c = {n: ev.main(n) for n in self.MAIN}
        ev.constraint(c["is_last_idx"] * (c["is_last_idx"] - 1))
        ev.constraint(c["lhs"] * c["rhs"] - c["out"] * SCALE - c["rem"])
        _transitions(ev, c, [("next_node_id", "node_id"), ("next_lhs_id", "lhs_id"), ("next_rhs_id", "rhs_id")])
        node = elems["node"]
        ev.relation(node, c["lhs_mult"], [c["lhs"], c["lhs_id"]])
        ev.relation(node, c["rhs_mult"], [c["rhs"], c["rhs_id"]])
        ev.relation(node, c["out_mult"], [c["out"], c["node_id"]])
        ev.finalize_logup()


class RecipComponent(Component):
    name = "recip"
    MAIN = "node_id input_id idx is_last_idx next_node_id next_input_id next_idx input out rem scale input_mult out_mult".split()
    N_INTERACTION = 2

    def evaluate(self, ev, elems):
        c = {n: ev.main(n) for n in self.MAIN}
        ev.constraint(c["is_last_idx"] * (c["is_last_idx"] - 1))
        ev.constraint(c["input"] * c["out"] + c["rem"] - c["scale"] * c["scale"])
        _transitions(ev, c, [("next_node_id", "node_id"), ("next_input_id", "input_id")])
        node = elems["node"]
        ev.relation(node, c["input_mult"], [c["input"], c["input_id"]])
        ev.relation(node, c["out_mult"], [c["out"], c["node_id"]])
        ev.finalize_logup()


class SqrtComponent(Component):
    name = "sqrt"
    MAIN = "node_id input_id idx is_last_idx next_node_id next_input_id next_idx input out rem scale input_mult out_mult".split()
    N_INTERACTION = 2

    def evaluate(self, ev, elems):
        c = {n: ev.main(n) for n in self.MAIN}
        ev.constraint(c["is_last_idx"] * (c["is_last_idx"] - 1))
        ev.constraint(c["out"] * c["out"] + c["rem"] - c["input"] * c["scale"])
        _transitions(ev, c, [("next_node_id", "node_id"), ("next_input_id", "input_id")])
        node = elems["node"]
        ev.relation(node, c["input_mult"], [c["input"], c["input_id"]])
        ev.relation(node, c["out_mult"], [c["out"], c["node_id"]])
        ev.finalize_logup()


class RemComponent(Component):
    name = "rem"
    MAIN = "node_id lhs_id rhs_id idx is_last_idx next_node_id next_lhs_id next_rhs_id next_idx lhs rhs rem quotient lhs_mult rhs_mult out_mult".split()
    N_INTERACTION = 3

    def evaluate(self, ev, elems):
        c = {n: ev.main(n) for n in self.MAIN}
        ev.constraint(c["is_last_idx"] * (c["is_last_idx"] - 1))
        ev.constraint(c["quotient"] * c["rhs"] + c["rem"] - c["lhs"])
        _transitions(ev, c, [("next_node_id", "node_id"), ("next_lhs_id", "lhs_id"), ("next_rhs_id", "rhs_id")])
        node = elems["node"]
        ev.relation(node, c["lhs_mult"], [c["lhs"], c["lhs_id"]])
        ev.relation(node, c["rhs_mult"], [c["rhs"], c["rhs_id"]])
        ev.relation(node, c["out_mult"], [c["rem"], c["node_id"]])
        ev.finalize_logup()


class _LutOpComponent(Component):
    """sin/exp2/log2: correctness enforced via the LUT LogUp relation
    (reference sin/component.rs:113-117), no algebraic constraint."""

    lut_kind = ""
    MAIN = "node_id input_id idx is_last_idx next_node_id next_input_id next_idx input out input_mult out_mult lookup_mult".split()
    N_INTERACTION = 3

    def evaluate(self, ev, elems):
        c = {n: ev.main(n) for n in self.MAIN}
        ev.constraint(c["is_last_idx"] * (c["is_last_idx"] - 1))
        _transitions(ev, c, [("next_node_id", "node_id"), ("next_input_id", "input_id")])
        node = elems["node"]
        ev.relation(node, c["input_mult"], [c["input"], c["input_id"]])
        ev.relation(node, c["out_mult"], [c["out"], c["node_id"]])
        ev.relation(elems[self.lut_kind], c["lookup_mult"], [c["input"], c["out"]])
        ev.finalize_logup()


class SinComponent(_LutOpComponent):
    name = "sin"
    lut_kind = "sin"


class Exp2Component(_LutOpComponent):
    name = "exp2"
    lut_kind = "exp2"


class Log2Component(_LutOpComponent):
    name = "log2"
    lut_kind = "log2"


class LessThanComponent(Component):
    name = "less_than"
    MAIN = "node_id lhs_id rhs_id idx is_last_idx next_node_id next_lhs_id next_rhs_id next_idx lhs rhs out borrow diff limb0 limb1 limb2 limb3 lhs_mult rhs_mult out_mult range_check_mult".split()
    N_INTERACTION = 7

    def evaluate(self, ev, elems):
        c = {n: ev.main(n) for n in self.MAIN}
        ev.constraint(c["is_last_idx"] * (c["is_last_idx"] - 1))
        ev.constraint(c["borrow"] * (c["borrow"] - 1))
        # out = (1 - borrow) * 2^12  (fixed-point 1.0 when lhs < rhs)
        ev.constraint(c["out"] - (ev.one() - c["borrow"]) * SCALE)
        # lhs + diff = rhs + borrow * (2^31 - 1)
        ev.constraint(c["lhs"] + c["diff"] - c["rhs"] - c["borrow"] * M31_MAX)
        # diff = sum limb_i * 2^(8i)
        ev.constraint(
            c["diff"]
            - c["limb0"]
            - c["limb1"] * (1 << 8)
            - c["limb2"] * (1 << 16)
            - c["limb3"] * (1 << 24)
        )
        _transitions(ev, c, [("next_node_id", "node_id"), ("next_lhs_id", "lhs_id"), ("next_rhs_id", "rhs_id")])
        node = elems["node"]
        rc = elems["range_check"]
        ev.relation(node, c["lhs_mult"], [c["lhs"], c["lhs_id"]])
        ev.relation(node, c["rhs_mult"], [c["rhs"], c["rhs_id"]])
        ev.relation(node, c["out_mult"], [c["out"], c["node_id"]])
        for limb in ("limb0", "limb1", "limb2", "limb3"):
            ev.relation(rc, c["range_check_mult"], [c[limb]])
        ev.finalize_logup()


class SumReduceComponent(Component):
    name = "sum_reduce"
    MAIN = "node_id input_id idx is_last_idx next_node_id next_input_id next_idx input out acc next_acc is_last_step input_mult out_mult".split()
    N_INTERACTION = 2
    MAIN_NEXT = ["acc"]

    def evaluate(self, ev, elems):
        c = {n: ev.main(n) for n in self.MAIN}
        ev.constraint(c["is_last_idx"] * (c["is_last_idx"] - 1))
        ev.constraint(c["is_last_step"] * (c["is_last_step"] - 1))
        ev.constraint(c["next_acc"] - c["acc"] - c["input"])
        ev.constraint((c["out"] - c["next_acc"]) * c["is_last_step"])
        # Row linking (beats the reference, whose acc chain is unbound
        # across rows -- sum_reduce/component.rs:69-70 constrains only the
        # free next_acc witness column): inside a segment the next row's
        # acc continues this row's next_acc; after a segment end (and on
        # padding rows, which pad is_last_step = 1) the next acc restarts
        # at 0.  Cyclic wrap is safe: the final row always has
        # is_last_step = 1 and row 0 starts a segment with acc = 0.
        acc_next = ev.main_next("acc")
        ev.constraint((ev.one() - c["is_last_step"]) * (acc_next - c["next_acc"]))
        ev.constraint(c["is_last_step"] * acc_next)
        _transitions(ev, c, [("next_node_id", "node_id"), ("next_input_id", "input_id")])
        node = elems["node"]
        ev.relation(node, c["input_mult"], [c["input"], c["input_id"]])
        ev.relation(node, c["out_mult"], [c["out"], c["node_id"]])
        ev.finalize_logup()


class MaxReduceComponent(Component):
    name = "max_reduce"
    MAIN = "node_id input_id idx is_last_idx next_node_id next_input_id next_idx input out max_val next_max_val is_max is_last_step ge_limb0 ge_limb1 ge_limb2 ge_limb3 input_mult out_mult range_check_mult".split()
    N_INTERACTION = 6
    MAIN_NEXT = ["max_val", "input"]

    def evaluate(self, ev, elems):
        c = {n: ev.main(n) for n in self.MAIN}
        ev.constraint(c["is_last_idx"] * (c["is_last_idx"] - 1))
        ev.constraint(c["is_max"] * (c["is_max"] - 1))
        ev.constraint(c["is_last_step"] * (c["is_last_step"] - 1))
        # is_max = 1 -> next_max = input;  is_max = 0 -> next_max = max_val.
        ev.constraint(c["is_max"] * (c["next_max_val"] - c["input"]))
        ev.constraint((ev.one() - c["is_max"]) * (c["next_max_val"] - c["max_val"]))
        # SOUNDNESS (beats the reference, max_reduce/component.rs:66-81,
        # where the >= relation is unconstrained and any visited value can
        # be claimed as the max): range-prove next_max >= both operands.
        # With the equalities above, next_max equals one operand; proving
        # next_max - loser >= 0 (loser = the one next_max does NOT equal)
        # pins next_max = max(input, max_val) exactly.  The difference is
        # decomposed into 8/8/8/6-bit limbs through the 8-bit range-check
        # relation (limb3 is checked as 4*limb3 < 2^8, so d < 2^30 --
        # sound for |fixed values| < 2^29, see docs/PROTOCOL.md).
        loser = c["is_max"] * c["max_val"] + (ev.one() - c["is_max"]) * c["input"]
        recomposed = (
            c["ge_limb0"]
            + c["ge_limb1"] * (1 << 8)
            + c["ge_limb2"] * (1 << 16)
            + c["ge_limb3"] * (1 << 24)
        )
        ev.constraint(recomposed - c["next_max_val"] + loser)
        ev.constraint((c["out"] - c["next_max_val"]) * c["is_last_step"])
        # Row linking (the reference's max_val chain is unbound across
        # rows): inside a segment the next row's max_val continues this
        # row's next_max_val; a new segment (after is_last_step = 1,
        # padding rows included -- they pad is_last_step = 1) anchors its
        # running max at its own first input.
        max_next = ev.main_next("max_val")
        ev.constraint((ev.one() - c["is_last_step"]) * (max_next - c["next_max_val"]))
        ev.constraint(c["is_last_step"] * (max_next - ev.main_next("input")))
        _transitions(ev, c, [("next_node_id", "node_id"), ("next_input_id", "input_id")])
        node = elems["node"]
        rc = elems["range_check"]
        ev.relation(node, c["input_mult"], [c["input"], c["input_id"]])
        ev.relation(node, c["out_mult"], [c["out"], c["node_id"]])
        ev.relation(rc, c["range_check_mult"], [c["ge_limb0"]])
        ev.relation(rc, c["range_check_mult"], [c["ge_limb1"]])
        ev.relation(rc, c["range_check_mult"], [c["ge_limb2"]])
        ev.relation(rc, c["range_check_mult"], [c["ge_limb3"] * 4])
        ev.finalize_logup()


class InputsComponent(Component):
    """CopyToStwo + Constant nodes: yield-only values into the node relation
    (reference inputs/components.rs:76-80)."""

    name = "inputs"
    MAIN = "node_id idx is_last_idx next_node_id next_idx val multiplicity".split()
    N_INTERACTION = 1

    def evaluate(self, ev, elems):
        c = {n: ev.main(n) for n in self.MAIN}
        ev.constraint(c["is_last_idx"] * (c["is_last_idx"] - 1))
        _transitions(ev, c, [("next_node_id", "node_id")])
        ev.relation(elems["node"], c["multiplicity"], [c["val"], c["node_id"]])
        ev.finalize_logup()


class ContiguousComponent(Component):
    name = "contiguous"
    MAIN = "node_id input_id idx is_last_idx next_node_id next_input_id next_idx input out input_mult out_mult".split()
    N_INTERACTION = 2

    def evaluate(self, ev, elems):
        c = {n: ev.main(n) for n in self.MAIN}
        ev.constraint(c["is_last_idx"] * (c["is_last_idx"] - 1))
        _transitions(ev, c, [("next_node_id", "node_id"), ("next_input_id", "input_id")])
        node = elems["node"]
        ev.relation(node, c["input_mult"], [c["input"], c["input_id"]])
        ev.relation(node, c["out_mult"], [c["out"], c["node_id"]])
        ev.finalize_logup()


class _LutTableComponent(Component):
    """The table side of a LUT argument: -multiplicity * (lut0, lut1)
    (reference lookups/sin/component.rs:40-59)."""

    lut_kind = ""
    MAIN = ["multiplicity"]
    N_INTERACTION = 1

    @property
    def PP_IDS(self):
        return [f"{self.lut_kind}_lut_0", f"{self.lut_kind}_lut_1"]

    def evaluate(self, ev, elems):
        lut0 = ev.preprocessed(f"{self.lut_kind}_lut_0")
        lut1 = ev.preprocessed(f"{self.lut_kind}_lut_1")
        mult = ev.main("multiplicity")
        ev.relation(elems[self.lut_kind], -mult, [lut0, lut1])
        ev.finalize_logup()


class SinLookupComponent(_LutTableComponent):
    name = "sin_lookup"
    lut_kind = "sin"


class Exp2LookupComponent(_LutTableComponent):
    name = "exp2_lookup"
    lut_kind = "exp2"


class Log2LookupComponent(_LutTableComponent):
    name = "log2_lookup"
    lut_kind = "log2"


class RangeCheckLookupComponent(Component):
    name = "range_check_lookup"
    MAIN = ["multiplicity"]
    N_INTERACTION = 1
    PP_IDS = ["range_check_8_column_0"]

    def evaluate(self, ev, elems):
        col = ev.preprocessed("range_check_8_column_0")
        mult = ev.main("multiplicity")
        ev.relation(elems["range_check"], -mult, [col])
        ev.finalize_logup()


#: Canonical component order -- fixes tree layout, claim order, and the
#: constraint alpha-power assignment.  (Reference equivalent: the fixed
#: member order of LuminairClaim, crates/air/src/lib.rs:30-163.)
class SquareComponent(Component):
    """out = x^2 in fixed point: x*x == out*2^S + rem (trunc semantics).

    The worked example of docs/contribute/add-ops.md -- a framework
    extension beyond the reference's 12 primitives (one operand
    consumption per row instead of mul's two).  Appended LAST in
    ALL_COMPONENTS: the canonical order is consensus-critical."""

    name = "square"
    MAIN = "node_id input_id idx is_last_idx next_node_id next_input_id next_idx input out rem input_mult out_mult".split()
    N_INTERACTION = 2

    def evaluate(self, ev, elems):
        c = {n: ev.main(n) for n in self.MAIN}
        ev.constraint(c["is_last_idx"] * (c["is_last_idx"] - 1))
        ev.constraint(c["input"] * c["input"] - c["out"] * SCALE - c["rem"])
        _transitions(ev, c, [("next_node_id", "node_id"), ("next_input_id", "input_id")])
        node = elems["node"]
        ev.relation(node, c["input_mult"], [c["input"], c["input_id"]])
        ev.relation(node, c["out_mult"], [c["out"], c["node_id"]])
        ev.finalize_logup()


ALL_COMPONENTS = [
    AddComponent(),
    MulComponent(),
    RecipComponent(),
    SqrtComponent(),
    RemComponent(),
    SinComponent(),
    Exp2Component(),
    Log2Component(),
    LessThanComponent(),
    SumReduceComponent(),
    MaxReduceComponent(),
    InputsComponent(),
    ContiguousComponent(),
    SinLookupComponent(),
    Exp2LookupComponent(),
    Log2LookupComponent(),
    RangeCheckLookupComponent(),
    # Post-reference extensions append strictly at the end (canonical
    # order is consensus-critical: claim encoding, tree layout, alphas).
    SquareComponent(),
]

COMPONENTS_BY_NAME = {c.name: c for c in ALL_COMPONENTS}
