"""Whole runs of each cell at small sizes on the CPU, and what a run loads."""

import json
import subprocess
import sys

import pytest
import torch

from port_bench import harness

from .conftest import BENCH, CELLS, run_tiny, tiny

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_tiny_run_is_correct_and_keyed(cell):
	r = run_tiny(cell)
	assert list(r) == KEYS
	assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 1
	want = {m["name"] for m in BENCH["end_to_end"] if harness.applies(m, cell)}
	assert set(r["metrics"]) == want
	assert all(set(v) == {"value", "unit"} for v in r["metrics"].values())
	assert set(r["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
	assert all(c["value"] <= c["limit"] for c in r["checks"].values())


def test_traced_run_keys():
	r = run_tiny("slq_dos.hofstadter4M", traced=True)
	assert list(r) == ["correct", "attempted", "failed", "metrics", "device", "breakdown", "checks"]
	assert {"busy_s", "window_s"} <= set(r["device"]) and r["device"]["window_s"] > 0
	assert set(r["breakdown"]) == {"device_ops", "idle_gaps"} and len(r["breakdown"]["idle_gaps"]) <= 10
	assert r["correct"] is True


def test_same_seed_same_answers():
	cell = harness.Cell("slq_logdet.path10M", "cpu", params={"n": 4096})
	import primate_tpu_torch as ptt

	cell.build(ptt)
	s = harness.call_seed(2**31 + 5, 3)
	assert cell.fn(s) == cell.fn(s) != cell.fn(s + 1)


def test_call_seeds_take_large_seeds():
	seeds = {harness.call_seed(2**31 + 11, i) for i in range(100)} | {harness.call_seed(2**40, 0), harness.call_seed(0, 0)}
	assert len(seeds) == 102 and all(0 <= s < 2**63 for s in seeds)


@pytest.mark.skipif(torch.cuda.is_available(), reason="a CUDA device is present, so the command runs")
def test_cli_without_a_card_prints_no_result():
	p = subprocess.run([sys.executable, "-m", "port_bench.run", "--workload", "slq_logdet.path10M", "--seed", "1", "--seconds", "1",
		"--trace", "0"], cwd=harness.REPO, capture_output=True, text=True, timeout=120)
	assert p.returncode != 0 and p.stdout.strip() == ""
	assert "CUDA" in p.stderr


def test_cli_past_its_look_for_a_card(monkeypatch, capsys):
	"""The command's whole path after its look for a card, on the CPU at a small size."""
	from port_bench import run

	monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
	monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
	monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "cpu")
	real = harness.run_cell

	def tiny_run(name, seed, seconds, traced, device, t_start, bench):
		return real(name, seed, 0.2, traced, device="cpu", t_start=t_start, params=tiny(name), bench=bench)

	monkeypatch.setattr(harness, "run_cell", tiny_run)
	assert run.main(["--workload", "slq_logdet.path10M", "--seed", str(2**31 + 3), "--seconds", "1", "--trace", "0"]) == 0
	out, err = capsys.readouterr()
	r = json.loads(out.strip().splitlines()[-1])
	assert list(r) == KEYS and r["correct"] is True
	assert err.strip().splitlines()[-1].startswith("check rel_gap = ")


LOADED = """
import json, sys
sys.path.insert(0, {repo!r})
{body}
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def top_level_modules(body: str) -> set:
	code = LOADED.format(repo=str(harness.REPO), body=body)
	p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300, check=True)
	return set(json.loads(p.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
	mods = top_level_modules(
		"from port_bench import harness\n"
		"harness.run_cell('kpm_dos.hofstadter4M', 7, 0.1, False, device='cpu', params={'nx': 20, 'ny': 16})"
	)
	assert "primate_tpu_torch" in mods
	assert not mods & {"jax", "jaxlib", "flax", "primate_tpu"}


def test_the_reference_loads_nothing_of_the_program():
	mods = top_level_modules(
		"import port_bench.reference as r\n"
		"from port_bench.reference import chebyshev, hofstadter, lanczos, path_laplacian, probes\n"
		"r.operator({'operator': 'hofstadter', 'params': {'nx': 5, 'ny': 4, 'alpha': 0.2, 'hopping': 1.0}, 'dtype': 'complex64'}, 'float64', 'cpu')"
	)
	assert not mods & {"primate_tpu_torch", "primate_tpu", "jax", "jaxlib", "flax"}
