"""On the card: each cell's command end to end at a short window, and the command refused in a
directory that holds only BENCHMARK.json and the benchmark's own files."""

import json
import shutil
import subprocess
import sys

import pytest

from port_bench import harness

from .conftest import BENCH, CELLS


def command(cwd, cell: str, trace: int, seconds: float = 2.0):
	return subprocess.run([sys.executable, "-m", "port_bench.run", "--workload", cell, "--seed", str(2**31 + 77), "--seconds",
		str(seconds), "--trace", str(trace)], cwd=cwd, capture_output=True, text=True, timeout=1200)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_on_the_card(cell, cuda_device):
	p = command(harness.REPO, cell, 0)
	assert p.returncode == 0, p.stderr[-4000:]
	r = json.loads(p.stdout.strip().splitlines()[-1])
	assert r["correct"] is True and r["device"]["platform"] == "gpu" and r["device"]["count"] == 1
	assert {m["name"] for m in BENCH["end_to_end"] if harness.applies(m, cell)} == set(r["metrics"])
	assert p.stderr.strip().splitlines()[-1].startswith("check ")


@pytest.mark.cuda
def test_benchmark_alone_is_refused(cuda_device, tmp_path):
	shutil.copy(harness.REPO / "BENCHMARK.json", tmp_path)
	shutil.copytree(harness.ROOT, tmp_path / "port_bench", ignore=shutil.ignore_patterns("__pycache__"))
	p = command(tmp_path, CELLS[0], 0, 1.0)
	assert p.returncode != 0
	assert not any('"correct"' in line for line in p.stdout.splitlines())
