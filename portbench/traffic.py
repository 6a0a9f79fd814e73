"""The one generator of the benchmark's traffic.  A configuration file
states its inputs' shapes and distributions and its weights' rule (and
seed); a mix file states the PCS profile and the request loop.  The
weights are drawn once, request i's inputs from stream (1, i) of --seed,
the warm-up's from (2, j), the profiled window's from (3, j).  Draws run on the run's device with
torch.Generator, in one call an input, then go to the host as float64
arrays, which the program and the reference both receive.  The same seed
on the same kind of device gives the same arrays."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .statement import Pcs

WEIGHT_RULES = ("normal_over_sqrt_fan_in",)


def stream_seed(seed: int, *stream: int) -> int:
    state = np.random.SeedSequence([seed % (1 << 64), *stream]).generate_state(1, np.uint64)[0]
    return int(state) & ((1 << 63) - 1)


def pcs(mix: dict) -> Pcs:
    p = mix["pcs"]
    return Pcs(int(p["pow_bits"]), int(p["log_blowup"]), int(p["n_queries"]), int(p["folds_per_layer"]),
               int(p["log_last_layer_degree_bound"]))


class Draws:
    def __init__(self, seed: int, device: torch.device):
        self.seed = seed
        self.device = torch.device(device)

    def _gen(self, *stream: int) -> torch.Generator:
        g = torch.Generator(device=self.device)
        g.manual_seed(stream_seed(self.seed, *stream))
        return g

    def weights(self, cfg: dict) -> Dict[str, np.ndarray]:
        """Linear layers' weights by the configuration's rule: w_i drawn
        normal with scale 1/sqrt(fan_in) in one call, biases zero; from
        the configuration's own seed where it states one (so that every
        --seed proves tables of the same sizes), else from --seed."""
        spec = cfg.get("weights", {})
        if spec.get("rule") is None:
            return {}
        if spec["rule"] not in WEIGHT_RULES:
            raise ValueError(f"unknown weight rule {spec['rule']}")
        layers = cfg["layers"]
        g = torch.Generator(device=self.device)
        g.manual_seed(stream_seed(int(spec["seed"]), 0) if "seed" in spec else stream_seed(self.seed, 0))
        z = torch.randn(sum(i * o for i, o in layers), generator=g, device=self.device,
                        dtype=torch.float64).cpu().numpy()
        out, at = {}, 0
        for k, (fan_in, fan_out) in enumerate(layers, start=1):
            out[f"w{k}"] = z[at : at + fan_in * fan_out].reshape(fan_in, fan_out) / np.sqrt(fan_in)
            out[f"b{k}"] = np.zeros(fan_out)
            at += fan_in * fan_out
        return out

    def inputs(self, cfg: dict, *stream: int) -> Dict[str, np.ndarray]:
        """One request's inputs: each named input's shape and either one
        distribution (`dist`) or one a trailing column (`columns`), each
        ["uniform", lo, hi] or ["normal", mean, std]."""
        g = self._gen(*stream)
        out = {}
        for name, spec in cfg["inputs"].items():
            shape = tuple(spec["shape"])
            rules = spec["columns"] if "columns" in spec else [spec["dist"]]
            if "columns" in spec and shape[-1] != len(rules):
                raise ValueError(f"input {name}: {len(rules)} column rules for shape {shape}")
            if len({r[0] for r in rules}) != 1:
                raise ValueError(f"input {name}: the columns of one input share one distribution")
            lo = torch.tensor([_affine(r)[0] for r in rules], dtype=torch.float64, device=self.device)
            sc = torch.tensor([_affine(r)[1] for r in rules], dtype=torch.float64, device=self.device)
            x = lo + sc * _base(rules[0][0], shape, g, self.device)
            out[name] = x.cpu().numpy()
        return out


def _affine(rule) -> tuple:
    kind, a, b = rule
    if kind == "uniform":
        return float(a), float(b) - float(a)
    if kind == "normal":
        return float(a), float(b)
    raise ValueError(f"unknown distribution {kind}")


def _base(kind: str, shape, g, device) -> torch.Tensor:
    fn = torch.rand if kind == "uniform" else torch.randn
    return fn(shape, generator=g, device=device, dtype=torch.float64)
