"""A whole run with the timed path broken underneath reads ``correct`` false, once for each fault a
cell can have (its call's ``faults``): a step that returns its state unchanged, half of the batch
left out (the mean taken over the rest), and an answer altered where it is produced. No cell runs
across chips, so none has an exchange to leave out."""

import pytest

from port_bench import harness

from .conftest import CELLS, run_tiny

CASES = [(cell, fault) for cell in CELLS for fault in harness.Cell(cell, "cpu").faults()]


@pytest.mark.parametrize("cell,fault", CASES, ids=[f"{c}-{f}" for c, f in CASES])
def test_broken_path_reads_incorrect(cell, fault, monkeypatch):
	harness.Cell(cell, "cpu").faults()[fault](monkeypatch.setattr)
	r = run_tiny(cell)
	assert r["correct"] is False, r["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_path_reads_correct(cell):
	assert run_tiny(cell)["correct"] is True
