"""The port stands alone: no JAX and nothing of luminair_tpu, and its entry
points default to the CUDA device."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "luminair_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top != "jax" and top != "jaxlib", f"{path}: imports {mod}"
        assert top != "luminair_tpu", f"{path}: imports {mod}"


def test_prelude_import_leaves_jax_out():
    code = (
        "import sys; import luminair_tpu_torch.prelude, luminair_tpu_torch.kernels; "
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'luminair_tpu' or m.startswith('luminair_tpu.')]; "
        "print(bad); sys.exit(1 if bad else 0)"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT), env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_prove_defaults_to_cuda():
    from luminair_tpu_torch.air.pie import pie_from_arrays
    from luminair_tpu_torch.air.settings import CircuitSettings
    from luminair_tpu_torch.errors import ProverError
    from luminair_tpu_torch.prover import prove

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    pie = pie_from_arrays({})
    with pytest.raises(ProverError, match="no CUDA device"):
        prove(pie, CircuitSettings())
    with pytest.raises(ProverError, match="no CUDA device"):
        prove(pie, CircuitSettings(), device="cuda")


def test_kernel_wrappers_reject_unsupported_tensors():
    from luminair_tpu_torch import kernels
    from luminair_tpu_torch.errors import KernelError

    with pytest.raises(KernelError):
        kernels.circle_ifft(torch.zeros((2, 8), dtype=torch.int64))
    with pytest.raises(KernelError):
        kernels.circle_ifft(torch.zeros((2, 6), dtype=torch.int32))
    with pytest.raises(KernelError):
        kernels.merkle_layer(torch.zeros((4, 8), dtype=torch.int32), torch.zeros((1, 3), dtype=torch.int32))
