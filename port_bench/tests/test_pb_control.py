"""The lower-precision control in the program's place fails each cell's limits, where the program
passes them, on three seeds: bfloat16 bands and sweep for the float32 path (the program's own
bfloat16 path), the reference with every stored vector rounded to bfloat16 for the complex64 lattice."""

import pytest

from port_bench import harness, readings

from .conftest import CELLS, tiny

SEEDS = [2**31 + 101, 2**31 + 102, 2**31 + 103]


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_program_passes(cell):
	limits = harness.load_json(harness.ROOT / "cells" / f"{cell}.json")["limits"]
	program = readings.readings(cell, SEEDS, False, device="cpu", params=tiny(cell, "control_params"))
	control = readings.readings(cell, SEEDS, True, device="cpu", params=tiny(cell, "control_params"))
	for key, lim in limits.items():
		assert max(r[key] for r in program) <= lim
		assert min(r[key] for r in control) > lim
