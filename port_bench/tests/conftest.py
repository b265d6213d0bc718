"""Small sizes at which the benchmark's cells run on the CPU, with the program's plain versions: each
configuration's own, under its ``"cpu"`` key (``params`` for a run, ``control_params`` for the
control test)."""

import pytest
import torch

from port_bench import harness

BENCH = harness.load_json(harness.REPO / "BENCHMARK.json")
CELLS = [w["name"] for w in BENCH["workloads"]]


def config(cell: str) -> dict:
	"""The configuration file of the cell."""
	entry = harness.by_name(BENCH["configs"], harness.by_name(BENCH["workloads"], cell, "workload")["config"], "config")
	return harness.load_json(harness.REPO / entry["file"])


def tiny(cell: str, sizes: str = "params") -> dict:
	return config(cell)["cpu"][sizes]


def run_tiny(cell: str, seed: int = 2**31 + 17, seconds: float = 0.2, traced: bool = False) -> dict:
	return harness.run_cell(cell, seed, seconds, traced, device="cpu", params=tiny(cell), bench=BENCH)


@pytest.fixture
def cuda_device():
	"""The card, or a skip where there is none."""
	if not torch.cuda.is_available():
		pytest.skip("needs an NVIDIA GPU")
	return torch.device("cuda", 0)
