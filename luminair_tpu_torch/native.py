"""ctypes binding to the native C++ verifier (native/verifier.cpp).

The native verifier re-runs the whole transcript from the flat wire format
(serde.proof_to_flat_bytes / settings_to_flat_bytes) with no Python
dependency.  `make -C native` builds it as `native/build/libluminair_verifier.so`
(this binding) and the `native/build/luminair-verify` CLI; `build` runs
that when the library is missing or older than its sources.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

from .errors import LuminairError

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "build", "libluminair_verifier.so")
_CLI_PATH = os.path.join(_NATIVE_DIR, "build", "luminair-verify")
_SOURCES = ("verifier.cpp", "air.inc", "verify.inc")

_lock = threading.Lock()
_lib = None

ERROR_NAMES = {
    0: "ok",
    1: "parse error",
    2: "structural error",
    3: "preprocessed root mismatch",
    4: "invalid LogUp",
    5: "composition OODS mismatch",
    6: "proof of work failed",
    7: "decommitment failed",
    8: "FRI check failed",
    9: "LUT output table out of tolerance",
    10: "proof config below required security bits",
}


class NativeVerifierError(LuminairError):
    def __init__(self, code: int, message: str):
        super().__init__(f"native verifier: {message} ({ERROR_NAMES.get(code, code)})")
        self.code = code


def build(force: bool = False) -> str:
    """Build the shared library and the CLI when missing or stale; returns
    the library's path."""
    if not force and os.path.exists(_LIB_PATH) and os.path.exists(_CLI_PATH):
        newest = max(os.path.getmtime(os.path.join(_NATIVE_DIR, s)) for s in _SOURCES)
        if min(os.path.getmtime(_LIB_PATH), os.path.getmtime(_CLI_PATH)) >= newest:
            return _LIB_PATH
    subprocess.run(["make", "-C", _NATIVE_DIR, "all"], check=True, capture_output=True, text=True)
    return _LIB_PATH


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            lib.luminair_verify_opts.restype = ctypes.c_int
            lib.luminair_verify_opts.argtypes = [
                ctypes.c_char_p,
                ctypes.c_size_t,
                ctypes.c_char_p,
                ctypes.c_size_t,
                ctypes.c_int,
                ctypes.c_char_p,
                ctypes.c_size_t,
            ]
            _lib = lib
    return _lib


def verify_flat(proof_bytes: bytes, settings_bytes: bytes, min_security_bits: int = 0) -> bool:
    """Verify flat proof and settings bytes; raises NativeVerifierError on
    rejection.  `min_security_bits` is a floor on the proof's PcsConfig
    (pow_bits + log_blowup * n_queries)."""
    lib = _load()
    err = ctypes.create_string_buffer(256)
    code = lib.luminair_verify_opts(proof_bytes, len(proof_bytes), settings_bytes, len(settings_bytes),
                                    int(min_security_bits), err, 256)
    if code != 0:
        raise NativeVerifierError(code, err.value.decode())
    return True


def verify(proof, settings, min_security_bits: int = 0) -> bool:
    """Verify a proof with the native verifier (through the flat wire
    format)."""
    from . import serde

    return verify_flat(serde.proof_to_flat_bytes(proof), serde.settings_to_flat_bytes(settings), min_security_bits)


def cli_path() -> str:
    build()
    return _CLI_PATH
