"""The flagship forward and the multi-device dry run.

    python3 -m luminair_tpu_torch.graft_entry [N] [--cpu]

entry(device=None)            -- the flagship model's forward (the
                                 black-scholes PINN, 2 -> 64 -> 64 -> 1,
                                 tanh) as an nn.Module, with its (1024, 2)
                                 input.
dryrun_multichip(n, device=None) -- an n-device mesh: the forward with dp
                                 over the batch and tp over the hidden
                                 features, then the full prove() of the
                                 simple graph under `prove_mesh` on a 1-D
                                 mesh and, for an even n >= 4, on a 2 x n/2
                                 ('hosts', 'chips') mesh.  Each proof's
                                 bytes must equal the one-device proof's,
                                 and the port's verify and native/ must
                                 accept it.

The counterpart of the reference package's root `__graft_entry__.py`.  On
the card the mesh takes n distinct cards when there are as many, and
otherwise n shards on the current card (a virtual mesh); the printed line
says which.  It runs on the CPU only when device="cpu" is passed.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from . import native, serde
from .errors import ProverError
from .parallel import sharding
from .prelude import FriConfig, Graph, PcsConfig, gen_circuit_settings, gen_trace, prove, verify
from .prover import resolve_device


def _flagship_params(rng_seed: int = 1234) -> dict:
    """The reference entry's parameters: {w1, b1, w2, b2, w3, b3} float32,
    w_i of shape (fan_in, fan_out), normal with scale 1/sqrt(fan_in), b_i
    zero."""
    rng = np.random.default_rng(rng_seed)
    params = {}
    for i, (fan_in, fan_out) in enumerate([(2, 64), (64, 64), (64, 1)], start=1):
        params[f"w{i}"] = rng.normal(scale=1.0 / np.sqrt(fan_in), size=(fan_in, fan_out)).astype(np.float32)
        params[f"b{i}"] = np.zeros(fan_out, dtype=np.float32)
    return params


class Flagship(torch.nn.Module):
    """tanh(tanh(x W1 + b1) W2 + b2) W3 + b3, W_i (fan_in, fan_out) as the
    reference keeps them."""

    def __init__(self, params: dict):
        super().__init__()
        for k, v in params.items():
            self.register_parameter(k, torch.nn.Parameter(torch.from_numpy(v.copy()), requires_grad=False))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = torch.tanh(x @ self.w1 + self.b1)
        h = torch.tanh(h @ self.w2 + self.b2)
        return h @ self.w3 + self.b3


def entry(device=None):
    """(module, x): the flagship forward on `device` (the CUDA device when
    None) and its (1024, 2) float32 input."""
    dev = resolve_device(device)
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(1024, 2)).astype(np.float32))
    return Flagship(_flagship_params()).to(dev), x.to(dev)


def _simple_graph() -> Graph:
    """The simple example's graph: (a * b + a) on 2 x 2 inputs."""
    cx = Graph()
    a = cx.tensor((2, 2)).set([[1.0, 2.0], [3.0, 4.0]])
    b = cx.tensor((2, 2)).set([[10.0, 20.0], [30.0, 40.0]])
    (a * b + a).retrieve()
    cx.compile()
    return cx


def _mesh_devices(n: int, device) -> tuple:
    """(devices, virtual): n distinct cards when there are as many, else n
    shards on one card; n shards on the CPU only when asked."""
    if device is not None and torch.device(device).type == "cpu":
        return [torch.device("cpu")] * n, n > 1
    dev = resolve_device(device)
    if device is None and torch.cuda.device_count() >= n:
        return [torch.device("cuda", i) for i in range(n)], False
    return [dev] * n, n > 1


def sharded_forward(module: Flagship, x: torch.Tensor, mesh: sharding.Mesh) -> torch.Tensor:
    """The forward over a ('rows', 'cols') mesh: x split by rows over
    'rows' (dp), w2 and b2 by columns over 'cols' (tp); device (r, c)
    computes its batch block's hidden features of block c, and the
    hidden activations are gathered onto (r, 0) with explicit copies
    before the last layer.  The result lands on the lead device."""
    R, C = mesh.devices.shape
    w2_cols = module.w2.shape[1]
    ys = []
    for r, (b0, b1) in enumerate(sharding.split_evenly(x.shape[0], R)):
        parts = []
        for c, (f0, f1) in enumerate(sharding.split_evenly(w2_cols, C)):
            dev = mesh.devices[r, c]
            xb = x[b0:b1].to(dev)
            h = torch.tanh(xb @ module.w1.to(dev) + module.b1.to(dev))
            parts.append(torch.tanh(h @ module.w2[:, f0:f1].to(dev) + module.b2[f0:f1].to(dev)))
        home = mesh.devices[r, 0]
        h = torch.cat([p.to(home) for p in parts], dim=1)
        ys.append((h @ module.w3.to(home) + module.b3.to(home)).to(mesh.lead))
    return torch.cat(ys)


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """The dry run (module docstring).  Raises on any mismatch; returns
    {"printed", "virtual", "devices", "seconds", ...}."""
    devs, virtual = _mesh_devices(n_devices, device)
    lead = devs[0]
    t0 = time.perf_counter()

    # --- the flagship forward, dp over the batch and tp over hidden features
    module, _ = entry(lead)
    mesh2d = sharding.make_mesh(n_devices, devices=devs)
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(16, 2)).astype(np.float32)).to(lead)
    y = sharded_forward(module, x, mesh2d)
    if tuple(y.shape) != (16, 1):
        raise ProverError(f"sharded forward gave shape {tuple(y.shape)}")
    want = module(x)
    err = float((y - want).abs().max() / want.abs().max())  # relative to the output's scale
    if err > 1e-5:
        raise ProverError(f"sharded forward differs from the one-device forward by {err} (relative)")

    # --- the full prove() over a 1-D mesh, and a hosts x chips mesh
    cx = _simple_graph()
    settings = gen_circuit_settings(cx, device=lead)
    pie = gen_trace(cx, settings, device=lead)
    cfg = PcsConfig(pow_bits=2, fri=FriConfig(log_blowup_factor=1, log_last_layer_degree_bound=0, n_queries=8))
    one = serde.proof_to_flat_bytes(prove(pie, settings, cfg, device=lead))
    meshes = [sharding.make_chip_mesh(n_devices, devices=devs)]
    if n_devices >= 4 and n_devices % 2 == 0:
        meshes.append(sharding.make_host_chip_mesh(2, n_devices // 2, devices=devs))
    for mesh in meshes:
        with sharding.prove_mesh(mesh):
            proof = prove(pie, settings, cfg)
        if serde.proof_to_flat_bytes(proof) != one:
            raise ProverError(f"the proof over {mesh} differs from the one-device proof")
        if not verify(proof, settings, device=lead) or not native.verify(proof, settings):
            raise ProverError(f"the proof over {mesh} was rejected")
    printed = (f"dryrun_multichip OK: mesh={meshes[0].shape}, devices={[str(d) for d in devs]}, "
               f"virtual={'true' if virtual else 'false'}, forward {tuple(y.shape)} (max relative error {err:.3g}), "
               f"full prove() over {n_devices} shards: proof bytes equal the one-device proof's, verified "
               f"(port + native)" + (f"; hosts x chips mesh {meshes[1].shape}: equal" if len(meshes) > 1 else ""))
    print(printed)
    return {"printed": printed, "virtual": virtual, "devices": [str(d) for d in devs], "forward_rel_err": err,
            "meshes": [m.shape for m in meshes], "proof_bytes": len(one), "seconds": time.perf_counter() - t0}


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    on_cpu = "--cpu" in sys.argv[1:]
    module, x = entry("cpu" if on_cpu else None)
    out = module(x)
    print("entry OK:", tuple(out.shape), float(out.mean()))
    dryrun_multichip(int(args[0]) if args else 4, "cpu" if on_cpu else None)
