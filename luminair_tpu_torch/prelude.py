"""User-facing facade.

    from luminair_tpu_torch.prelude import *

    cx = Graph()
    a = cx.tensor((2, 2)).set([...])
    b = cx.tensor((2, 2)).set([...])
    c = (a * b + a).retrieve()
    cx.compile()
    settings = gen_circuit_settings(cx)
    pie = gen_trace(cx, settings)
    proof = prove(pie, settings)          # on the CUDA device
    proof = prove(pie, settings, device="cpu")
"""

from .graph.graph import Graph, GraphTensor
from .graph.trace import execute, gen_circuit_settings, gen_trace
from .air.pie import LuminairPie
from .air.settings import CircuitSettings
from .pcs.config import FriConfig, PcsConfig
from .prover import LuminairProof, prove
from .errors import EmptyTraceError, KernelError, LuminairError, ProverError

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
    "EmptyTraceError",
    "KernelError",
    "LuminairError",
    "ProverError",
]
