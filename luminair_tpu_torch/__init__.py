"""luminair_tpu_torch: the Circle-STARK prover on PyTorch and CUDA.

A port of the `luminair_tpu` package (JAX) for an NVIDIA Hopper GPU.  Proofs
are byte-identical to the reference package's host proofs.  Entry points run
on the CUDA device unless the caller passes device="cpu".
"""

__version__ = "0.1.0"
