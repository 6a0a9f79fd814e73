"""A Circle-STARK verifier of the proofs' wire format, in standalone C++
(`native/`, a frozen copy: the transcript, the preprocessed tree
recommitted from the settings, the LogUp balance, the composition at the
OODS point, PoW, Merkle decommitments, DEEP quotients and FRI folds).
Built once per checkout with the host's C++ compiler into
build/portbench/native/, under a name drawn from its sources, so a later
run finds it built."""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

SOURCES = ("verifier.cpp", "air.inc", "verify.inc")
_DIR = Path(__file__).resolve().parent / "native"

CODES = {0: "ok", 1: "parse error", 2: "structural error", 3: "preprocessed root mismatch",
         4: "invalid LogUp", 5: "composition OODS mismatch", 6: "proof of work failed",
         7: "decommitment failed", 8: "FRI check failed", 9: "LUT output table out of tolerance",
         10: "proof config below required security bits"}


CHECKOUT = _DIR.parents[2]  # the checkout that holds portbench/


def library_path() -> Path:
    h = hashlib.sha256()
    for s in SOURCES:
        h.update((_DIR / s).read_bytes())
    return CHECKOUT / "build" / "portbench" / "native" / f"verifier-{h.hexdigest()[:16]}.so"


class Verifier:
    def __init__(self):
        path = library_path()
        if not path.exists():
            path.parent.mkdir(parents=True, exist_ok=True)
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            subprocess.run([os.environ.get("CXX", "g++"), "-O2", "-std=c++17", "-fPIC", "-shared",
                            "-o", str(tmp), str(_DIR / "verifier.cpp")], check=True, capture_output=True)
            os.replace(tmp, path)
        lib = ctypes.CDLL(str(path))
        lib.luminair_verify_opts.restype = ctypes.c_int
        lib.luminair_verify_opts.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p, ctypes.c_size_t,
                                             ctypes.c_int, ctypes.c_char_p, ctypes.c_size_t]
        self._lib = lib

    def verify(self, proof: bytes, settings: bytes, min_security_bits: int) -> tuple:
        """(code, message): code 0 accepts."""
        err = ctypes.create_string_buffer(256)
        code = self._lib.luminair_verify_opts(proof, len(proof), settings, len(settings),
                                              int(min_security_bits), err, 256)
        return code, err.value.decode(errors="replace") or CODES.get(code, str(code))
