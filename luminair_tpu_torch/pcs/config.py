"""PCS / FRI configuration.

Mirrors the role of stwo's ``PcsConfig`` used by the reference at
crates/prover/src/prover.rs:36 (``PcsConfig::default()``).  Defaults follow
stwo's: blowup 2^1, ~secure query count for conjectured security with proof
of work.

Security model (documented in docs/PROTOCOL.md "Security parameters"):
conjectured soundness ≈ pow_bits + n_queries * log_blowup_factor bits.
The default profile (5 + 15*1 = 20 bits) matches the reference's
stwo-default posture and is meant for benchmarking/integrity checking;
use ``PcsConfig.high_security()`` (16 + 64*1 = 80 bits) for adversarial
settings, or ``PcsConfig.high_security(log_blowup=2)`` (16 + 32*2 = 80 bits)
which halves the query/opening count at the cost of 2x larger committed
trees.  Constraints are evaluated pointwise on the full commit domain, so
any blowup in 1..4 works end-to-end across all three verifiers.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class FriConfig:
    log_blowup_factor: int = 1
    # Stop folding at degree 2^4: each extra committed FRI layer costs the
    # prover a Merkle tree + a transcript round trip, while 16 last-layer
    # coefficients cost the proof 256 bytes and the verifier one tiny
    # interpolation.  prove() clamps this down automatically when the
    # smallest committed column is too short for it.
    log_last_layer_degree_bound: int = 4
    n_queries: int = 15
    # Line-fold steps per committed FRI layer (layer arity = 2^this).  Fold
    # step t of a layer uses challenge alpha^(2^t) from the layer's single
    # drawn alpha (standard higher-arity FRI batching).  Each committed
    # layer costs the prover one Merkle tree + transcript round trip and
    # the proof one root + witness set, so 2 halves both vs. classic
    # fold-per-commit FRI; queries open 2^folds-position cosets per layer.
    folds_per_layer: int = 2

    def __post_init__(self):
        # Match the range the native/JS wire parsers enforce so verifier
        # behavior never diverges across implementations for one config.
        if not (1 <= int(self.log_blowup_factor) <= 4):
            raise ValueError(
                f"log_blowup_factor must be in 1..4, got {self.log_blowup_factor}"
            )
        if not (1 <= int(self.folds_per_layer) <= 8):
            raise ValueError(
                f"folds_per_layer must be in 1..8, got {self.folds_per_layer}"
            )
        if not (0 <= int(self.log_last_layer_degree_bound) <= 30):
            raise ValueError(
                "log_last_layer_degree_bound must be in 0..30, got "
                f"{self.log_last_layer_degree_bound}"
            )


@dataclass
class PcsConfig:
    pow_bits: int = 5
    fri: FriConfig = field(default_factory=FriConfig)

    @property
    def log_blowup(self) -> int:
        return self.fri.log_blowup_factor

    def security_bits(self) -> int:
        return self.pow_bits + self.fri.log_blowup_factor * self.fri.n_queries

    @staticmethod
    def high_security(log_blowup: int = 1) -> "PcsConfig":
        """≥80 conjectured bits: 16 PoW bits + ceil(64 / blowup) queries.

        blowup 1 -> 64 queries (smallest committed trees); blowup 2 -> 32
        queries (half the openings / roughly half the proof size, 2x the
        committed-tree rows).  Pick by whether prover memory or proof size
        is the binding constraint."""
        q = -(-64 // int(log_blowup))
        return PcsConfig(
            pow_bits=16, fri=FriConfig(log_blowup_factor=log_blowup, n_queries=q)
        )

    def to_dict(self):
        return {
            "pow_bits": self.pow_bits,
            "fri": {
                "log_blowup_factor": self.fri.log_blowup_factor,
                "log_last_layer_degree_bound": self.fri.log_last_layer_degree_bound,
                "n_queries": self.fri.n_queries,
                "folds_per_layer": self.fri.folds_per_layer,
            },
        }

    @staticmethod
    def from_dict(d):
        return PcsConfig(
            pow_bits=d["pow_bits"],
            fri=FriConfig(
                log_blowup_factor=d["fri"]["log_blowup_factor"],
                log_last_layer_degree_bound=d["fri"]["log_last_layer_degree_bound"],
                n_queries=d["fri"]["n_queries"],
                folds_per_layer=d["fri"].get("folds_per_layer", 1),
            ),
        )
