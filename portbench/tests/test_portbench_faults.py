"""Drive runs with the timed path broken underneath: each fault a cell can
have turns `correct` false (the look for a card is skipped; the runs are
on the CPU at small sizes)."""

import time

import numpy as np
import pytest

from conftest import SEED


def _run(tiny, cell):
    from portbench import harness

    return harness.run(tiny, cell, SEED, 0.6, False, "cpu", time.perf_counter())


def test_an_output_altered_where_it_is_produced(tiny, monkeypatch):
    from luminair_tpu_torch.graph.graph import GraphTensor

    real = GraphTensor.data

    def altered(self):
        out = real(self).copy()
        out.reshape(-1)[1] += 1.0 / 4096
        return out

    monkeypatch.setattr(GraphTensor, "data", altered)
    r = _run(tiny, "mul_add.pcs20")
    assert r["correct"] is False and r["checks"]["outputs_off"]["value"] >= 1


def test_a_proof_altered_where_it_is_produced(tiny, monkeypatch):
    from luminair_tpu_torch import serde

    real = serde.proof_to_flat_bytes

    def altered(proof):
        data = bytearray(real(proof))
        data[-64] ^= 0x10  # inside the openings
        return bytes(data)

    monkeypatch.setattr(serde, "proof_to_flat_bytes", altered)
    r = _run(tiny, "mul_add.pcs20")
    assert r["correct"] is False and r["checks"]["proofs_rejected"]["value"] >= 1


def test_a_lut_range_altered_where_it_is_produced(tiny, monkeypatch):
    from luminair_tpu_torch import prelude
    from luminair_tpu_torch.air.preprocessed import LookupLayout, Range, finalize_lookups

    real = prelude.gen_circuit_settings

    def widened(graph, device=None):
        s = real(graph, device=device)
        r = s.lookups.exp2.ranges
        s.lookups.exp2 = LookupLayout([Range(r[0].lo - 1, r[0].hi)] + r[1:])
        finalize_lookups(s.lookups)
        return s

    monkeypatch.setattr(prelude, "gen_circuit_settings", widened)
    r = _run(tiny, "bs_pinn.pcs20")
    assert r["correct"] is False and r["checks"]["settings_off"]["value"] >= 1


def test_a_request_that_fails(tiny, monkeypatch):
    from luminair_tpu_torch import prelude
    from luminair_tpu_torch.errors import ProverError

    from portbench import harness

    calls = []  # the window's proves: counted once set-up has settled
    real, real_settled = prelude.prove, harness.settled

    def settled(warm):
        done = real_settled(warm)
        calls.clear()
        return done

    def sometimes(*a, **k):
        calls.append(1)
        if len(calls) == 2:
            raise ProverError("fault planted by the test")
        return real(*a, **k)

    monkeypatch.setattr(harness, "settled", settled)
    monkeypatch.setattr(prelude, "prove", sometimes)
    r = _run(tiny, "mul_add.pcs20")
    assert r["correct"] is False and r["failed"] == 1 and r["checks"]["requests_failed"]["value"] == 1


def test_a_weaker_profile_in_the_program(tiny, monkeypatch):
    """A proof at fewer queries than the mix states."""
    from luminair_tpu_torch import prelude

    real = prelude.prove

    def weaker(pie, settings, config=None, device=None):
        config.fri.n_queries -= 1
        try:
            return real(pie, settings, config, device=device)
        finally:
            config.fri.n_queries += 1

    monkeypatch.setattr(prelude, "prove", weaker)
    r = _run(tiny, "mul_add.pcs20")
    assert r["correct"] is False and r["checks"]["header_off"]["value"] >= 1
    assert r["checks"]["proofs_rejected"]["value"] >= 1
