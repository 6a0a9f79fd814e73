"""User-facing facade.

    from luminair_tpu_torch.prelude import *

    cx = Graph()
    a = cx.tensor((2, 2)).set([...])
    b = cx.tensor((2, 2)).set([...])
    c = (a * b + a).retrieve()
    cx.compile()
    settings = gen_circuit_settings(cx)   # on the CUDA device
    pie = gen_trace(cx, settings)         # columns born on the card
    proof = prove(pie, settings)          # reads them where they lie
    verify(proof, settings)               # recommits the preprocessed tree there

Each entry point takes device="cpu" to run on the CPU instead.
"""

from .graph.graph import Graph, GraphTensor
from .graph.trace import execute, gen_circuit_settings, gen_trace
from .air.pie import LuminairPie
from .air.settings import CircuitSettings
from .pcs.config import FriConfig, PcsConfig
from .prover import LuminairProof, prove
from .verifier import verify
from .errors import (
    EmptyTraceError,
    InvalidLogUpError,
    KernelError,
    LuminairError,
    ProverError,
    StwoVerifierError,
)

__all__ = [
    "Graph",
    "GraphTensor",
    "execute",
    "gen_circuit_settings",
    "gen_trace",
    "LuminairPie",
    "CircuitSettings",
    "FriConfig",
    "PcsConfig",
    "LuminairProof",
    "prove",
    "verify",
    "EmptyTraceError",
    "InvalidLogUpError",
    "KernelError",
    "LuminairError",
    "ProverError",
    "StwoVerifierError",
]
