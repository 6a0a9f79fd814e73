"""Several devices: the mesh and the sharded prover (sharding.py)."""
