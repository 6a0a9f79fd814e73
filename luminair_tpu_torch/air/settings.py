"""CircuitSettings: lookup-table layouts shared by prover and verifier."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from .preprocessed import LookupLayout


@dataclass
class Lookups:
    sin: Optional[LookupLayout] = None
    exp2: Optional[LookupLayout] = None
    log2: Optional[LookupLayout] = None
    range_check_bits: Optional[int] = None  # 8 when less_than is present

    def to_dict(self):
        return {
            "sin": self.sin.to_dict() if self.sin else None,
            "exp2": self.exp2.to_dict() if self.exp2 else None,
            "log2": self.log2.to_dict() if self.log2 else None,
            "range_check_bits": self.range_check_bits,
        }

    @staticmethod
    def from_dict(d):
        return Lookups(
            sin=LookupLayout.from_dict(d["sin"]) if d.get("sin") else None,
            exp2=LookupLayout.from_dict(d["exp2"]) if d.get("exp2") else None,
            log2=LookupLayout.from_dict(d["log2"]) if d.get("log2") else None,
            range_check_bits=d.get("range_check_bits"),
        )


@dataclass
class CircuitSettings:
    lookups: Lookups = field(default_factory=Lookups)

    def to_dict(self):
        return {"lookups": self.lookups.to_dict()}

    @staticmethod
    def from_dict(d):
        return CircuitSettings(Lookups.from_dict(d["lookups"]))


def settings_from_dict(d) -> CircuitSettings:
    """CircuitSettings from the plain dict form (`to_dict` of either
    package's settings)."""
    return CircuitSettings.from_dict(d)
