"""verify(proof, settings): the cheap side of the STARK.

Rebuilds the preprocessed trace from the settings and recommits it on the
card (circle iFFT and LDE, K1; the Blake2s Merkle tree, K2: the prover's
phase 0), replays the transcript (claim -> roots -> elements -> claimed
sums -> composition alpha -> OODS point), checks the global LogUp sum and
the composition identity at the OODS point, then the DEEP quotients, FRI
and the Merkle decommitments at the drawn queries.  Everything after the
recommit is exact integer arithmetic on the host, as in the reference
package's verifier.py; it calls no kernel.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from . import circle
from . import fields as f
from . import serde, tracing
from .air.layout import AirLayout
from .air.preprocessed import validate_lut_outputs
from .crypto.channel import Blake2sChannel
from .errors import InvalidLogUpError, StwoVerifierError
from .pcs.scheme import CommitmentSchemeVerifier, TreeProver
from .prover import resolve_device
from .selfcheck import composition_oods_matches

#: The preprocessed roots of recent verifies, keyed by the settings' flat
#: bytes, the preprocessed logs and the blowup: the recommit depends on
#: nothing else, and verifies of many proofs share one circuit.
_PP_ROOT_CACHE: Dict[tuple, np.ndarray] = {}
_PP_ROOT_CACHE_SIZE = 16


def _validate_lut_tables(settings) -> None:
    """The settings' LUT output tables are part of the public statement:
    each must approximate its function within the normative tolerance
    before the verifier trusts it."""
    for kind in ("sin", "exp2", "log2"):
        layout = getattr(settings.lookups, kind, None)
        if layout is not None and layout.outputs is not None:
            ok, n_bad = validate_lut_outputs(kind, layout.all_values(), layout.outputs)
            if not ok:
                raise StwoVerifierError(f"{kind} LUT output table out of tolerance ({n_bad} entries)")


def _preprocessed_root(layout: AirLayout, settings, log_blowup: int, dev) -> np.ndarray:
    """The root of the preprocessed tree, recommitted on `dev` from the
    settings (the columns uploaded, a TreeProver built as the prover's
    phase 0 builds it; only its root is kept)."""
    key = (serde.settings_to_flat_bytes(settings), tuple(layout.pp_logs()), int(log_blowup))
    root = _PP_ROOT_CACHE.get(key)
    if root is None:
        if len(_PP_ROOT_CACHE) >= _PP_ROOT_CACHE_SIZE:
            _PP_ROOT_CACHE.clear()
        root = TreeProver([f.u32_to_tensor(c, dev) for c in layout.pp.columns()], log_blowup).root
        _PP_ROOT_CACHE[key] = root
    return root


def verify(proof, settings, expected_config=None, min_security_bits: int = 0, device=None) -> bool:
    """Raises on failure (StwoVerifierError, InvalidLogUpError); returns
    True on acceptance.

    The PCS parameters ride in the proof, so a verifier that accepts
    whatever arrives is open to a parameter downgrade: pass
    `expected_config` to require an exact PcsConfig, or `min_security_bits`
    for a floor on `proof.config.security_bits()` (e.g. 80).  The
    recommit runs on the CUDA device unless `device` says otherwise
    (device="cpu")."""
    dev = resolve_device(device)
    config = proof.config
    if expected_config is not None and config != expected_config:
        raise StwoVerifierError(f"proof config {config} != expected {expected_config}")
    if config.security_bits() < min_security_bits:
        raise StwoVerifierError(
            f"proof offers {config.security_bits()} security bits; caller requires >= {min_security_bits}"
        )
    with tracing.root("verify", tracing.request_of(settings), dev, phases_sync=True):
        return _verify(proof, settings, config, dev)


def _verify(proof, settings, config, dev) -> bool:
    span = tracing.span
    with span("lut_validation"):
        _validate_lut_tables(settings)
    channel = Blake2sChannel()

    claim = proof.claim
    claim.mix_into(channel)
    layout = AirLayout(claim, settings)
    pcs = CommitmentSchemeVerifier(config, channel)

    # Tree 0: the verifier rebuilds the preprocessed columns and recommits
    # them; the root must be the prover's.
    with span("preprocessed_recommit"):
        expect_root = _preprocessed_root(layout, settings, config.log_blowup, dev)
        if not np.array_equal(expect_root, np.asarray(proof.roots[0])):
            raise StwoVerifierError("preprocessed tree root mismatch")
    pcs.commit(proof.roots[0], layout.pp_logs())
    pcs.commit(proof.roots[1], layout.main_logs)

    elems = layout.draw_elements(channel)

    if not proof.interaction_claim.is_balanced():
        raise InvalidLogUpError("sum of claimed LogUp sums != 0")
    proof.interaction_claim.mix_into(channel)
    pcs.commit(proof.roots[2], layout.inter_logs)

    alpha = f.host_i64(channel.draw_felt())
    pcs.commit(proof.roots[3], [layout.composition_log] * 4)

    z = circle.point_from_t_qm31(f.host_i64(channel.draw_felt()))
    sample_points = layout.sample_points(z)

    with span("oods_composition_check"):
        if not composition_oods_matches(layout, claim, proof, elems, alpha, z):
            raise StwoVerifierError("composition polynomial OODS mismatch")

    with span("pcs_fri_decommit"):
        if not pcs.verify_values(sample_points, proof.pcs_proof):
            raise StwoVerifierError("PCS verification failed")
    return True
