"""Small sizes at which the benchmark's cells run on the CPU, with the program's plain versions."""

import pytest
import torch

from port_bench import harness

# The configurations' sizes cut for a CPU run: the path at 4096 rows, the lattice at 40 × 48 sites
# (40 a multiple of 5, so the flux closes around the periodic lattice).
TINY = {"path10M_f32": {"n": 4096}, "hofstadter4M_c64": {"nx": 40, "ny": 48}}
# The control test's sizes: the program's bfloat16 path on the CPU reads 8e-4-1.1e-3 on the path at 2048 rows,
# and 1.6e-4-2.8e-4 at 4096, beside the card's 5.8e-3 at the cell's 10M rows.
CONTROL_SIZES = {**TINY, "path10M_f32": {"n": 2048}}
BENCH = harness.load_json(harness.REPO / "BENCHMARK.json")
CELLS = [w["name"] for w in BENCH["workloads"]]


def tiny(cell: str, sizes: dict = TINY) -> dict:
	return sizes[harness.by_name(BENCH["workloads"], cell, "workload")["config"]]


def run_tiny(cell: str, seed: int = 2**31 + 17, seconds: float = 0.2, traced: bool = False) -> dict:
	return harness.run_cell(cell, seed, seconds, traced, device="cpu", params=tiny(cell), bench=BENCH)


@pytest.fixture
def cuda_device():
	"""The card, or a skip where there is none."""
	if not torch.cuda.is_available():
		pytest.skip("needs an NVIDIA GPU")
	return torch.device("cuda", 0)
