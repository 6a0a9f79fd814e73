"""The simple example on the PyTorch/CUDA port (luminair_tpu_torch): a 2x2
mul + add graph through compile -> settings -> trace -> prove -> verify
(the port's verifier and native/), then the proof and settings written to
files, read back and verified again.

    python3 examples/torch_simple.py          # on the CUDA device
    python3 examples/torch_simple.py --cpu    # on the CPU

The files go under build/examples/ at the repository root.
"""

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from luminair_tpu_torch import native, serde
from luminair_tpu_torch.prelude import CircuitSettings, Graph, gen_circuit_settings, gen_trace, prove, verify

OUT_DIR = os.path.join(ROOT, "build", "examples")


def main(device=None, out_dir: str = OUT_DIR) -> dict:
    """Runs the example on `device` (the CUDA device when None; raises
    without one) and returns what it printed (`printed`, one string a
    line), the output, the proof, the settings and the seconds of the prove
    and of each verify."""
    printed = []

    def say(line: str) -> None:
        print(line, flush=True)
        printed.append(line)

    cx = Graph()
    a = cx.tensor((2, 2)).set([[1.0, 2.0], [3.0, 4.0]])
    b = cx.tensor((2, 2)).set([[10.0, 20.0], [30.0, 40.0]])
    c = (a * b + a).retrieve()
    cx.compile()

    settings = gen_circuit_settings(cx, device=device)
    pie = gen_trace(cx, settings, device=device)

    t0 = time.perf_counter()
    proof = prove(pie, settings, device=device)
    prove_s = time.perf_counter() - t0
    say(f"proved in {prove_s:.2f}s")

    t0 = time.perf_counter()
    assert verify(proof, settings, device=device)
    verify_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    assert native.verify(proof, settings)
    native_s = time.perf_counter() - t0
    say(f"verified in {verify_s:.2f}s (native/ {native_s:.2f}s)")

    output = c.data().tolist()
    say(f"output: {output}")

    os.makedirs(out_dir, exist_ok=True)
    proof_path, settings_path = os.path.join(out_dir, "proof.bin"), os.path.join(out_dir, "settings.json")
    serde.proof_to_file(proof, proof_path)
    settings.to_json_file(settings_path)
    again = serde.proof_from_file(proof_path)
    assert verify(again, CircuitSettings.from_json_file(settings_path), device=device)
    say("serialized proof re-verified OK")
    return {"printed": printed, "output": output, "proof": proof, "settings": settings, "prove_seconds": prove_s,
            "verify_seconds": verify_s, "native_verify_seconds": native_s, "files": (proof_path, settings_path)}


if __name__ == "__main__":
    main(device="cpu" if "--cpu" in sys.argv[1:] else None)
