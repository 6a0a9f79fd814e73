"""The controls at a small size: each fails one of the check's numbers, the
program none."""

import pytest

from conftest import SEED


@pytest.mark.parametrize("cell", ["mul_add.pcs20", "bs_pinn.pcs80_b2"])
def test_the_controls_fail_and_the_program_passes(tiny, cell):
    from portbench import control

    for line in control.readings(tiny, cell, [SEED, 11], 2, "cpu"):
        assert all(v == 0 for v in line["program"].values()), line
        assert line["float32"]["outputs_off"] > 0, line
        assert (line["float32"]["settings_off"] > 0) == cell.startswith("bs_pinn"), line
        assert line["fewer_queries"]["header_off"] > 0 and line["fewer_queries"]["proofs_rejected"] == 2, line
