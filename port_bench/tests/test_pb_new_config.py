"""A configuration is new files and two entries of ``BENCHMARK.json``, nothing else.

In a copy of ``BENCHMARK.json`` and ``port_bench/``, each case adds a small configuration as new
files only (its configuration file, a traffic file for the existing ``slq_trace`` call, a ``cells/``
limits file and, for a new kind, its operator and reference modules), appends one ``configs`` and
one ``workloads`` entry to the copy's ``BENCHMARK.json``, and names the new cell among the
``workloads`` of the per-layer metrics that every cell reports, as a cell needs one. A run of the
new cell, in a process started in the copy, reads ``correct``, and the benchmark's own CPU tests of
it pass there. Every other file of the copy that was there before is the repo's, byte for byte.
"""

import json
import os
import shutil
import subprocess
import sys

import pytest

from port_bench import harness

SLQ_TRAFFIC = {"call": "slq_trace", "fun": "log", "deg": 12, "orth": 0, "reorth_passes": 2, "batch": 8, "count": 16,
	"pdf": "rademacher", "loop": "closed, one caller: log det from 16 Rademacher probes through 12 Lanczos steps"}
LIMITS = {"checked_calls": 2, "limits": {"rel_gap": 1e-5}}

MESH_OPERATOR = '''"""The 5-point Laplacian of an nx x ny grid plus shift x I as five bands."""

import torch


def bands(params, dtype, device):
	nx, ny, s = int(params["nx"]), int(params["ny"]), float(params["shift"])
	n = nx * ny
	y = torch.arange(n, device=device) % ny
	b = torch.zeros((5, n), dtype=dtype, device=device)
	b[0, ny:] = -1
	b[1] = torch.where(y >= 1, -1.0, 0.0)
	b[2] = 4.0 + s
	b[3] = torch.where(y < ny - 1, -1.0, 0.0)
	b[4, : n - ny] = -1
	return b, (-ny, -1, 0, 1, ny), (n, n)
'''

MESH_REFERENCE = '''"""The 5-point Laplacian of an nx x ny grid (zero outside) plus shift x I, on the grid."""


def size(params):
	return int(params["nx"]) * int(params["ny"])


def apply(params, X, rnd=lambda x: x):
	nx, ny, s = int(params["nx"]), int(params["ny"]), float(params["shift"])
	Z = X.reshape(X.shape[0], nx, ny)
	Y = Z * (4.0 + s)
	Y[:, 1:] -= Z[:, :-1]
	Y[:, :-1] -= Z[:, 1:]
	Y[:, :, 1:] -= Z[:, :, :-1]
	Y[:, :, :-1] -= Z[:, :, 1:]
	return Y.reshape(X.shape)


def interval(params):
	s = float(params["shift"])
	return s, 8.0 + s
'''

# The per-layer metrics that read any call, since every cell reports them.
BENCH = harness.load_json(harness.REPO / "BENCHMARK.json")
EVERY_CELLS = {m["name"] for m in BENCH["per_layer"] if {w["name"] for w in BENCH["workloads"]} <= set(m.get("workloads", ()))}

CASES = {
	"bsr": dict(
		config={"name": "bsr_small_f32", "operator": "block_random_spd", "format": "bsr", "dtype": "float32",
			"params": {"n": 2048, "bs": 8, "density": 0.018, "seed": 11}, "control": {"program_dtype": "bfloat16"},
			"cpu": {"params": {}, "control_params": {}}, "reduced": [],
			"source": "benchmarks/matrices.py block_random_spd at a small size"},
		files={},
		why="a small block-random SPD matrix of 8 x 8 tiles: bsr_spmm's path"),
	"dia": dict(
		config={"name": "mesh_small_f32", "operator": "mesh5", "format": "dia", "dtype": "float32",
			"params": {"nx": 40, "ny": 50, "shift": 1.0}, "control": {"program_dtype": "bfloat16"},
			"cpu": {"params": {}, "control_params": {}}, "reduced": [],
			"source": "the 5-point mesh plus I of the heat-kernel example, at 40 x 50 points"},
		files={"operators/mesh5.py": MESH_OPERATOR, "reference/mesh5.py": MESH_REFERENCE},
		why="a new DIA kind, five bands: passes A and B"),
}


def files_of(root) -> dict:
	return {p.relative_to(root).as_posix(): p.read_bytes() for p in sorted(root.rglob("*"))
		if p.is_file() and "__pycache__" not in p.parts}


def add_configuration(copy, case: dict) -> str:
	"""The case's new files in the copy and its two entries in the copy's ``BENCHMARK.json``; returns
	the new cell's name."""
	cfg = case["config"]
	cell = f"slq_logdet_small.{cfg['name']}"
	for rel, text in case["files"].items():
		(copy / "port_bench" / rel).write_text(text)
	(copy / "port_bench" / "configs" / f"{cfg['name']}.json").write_text(json.dumps(cfg, indent=2))
	(copy / "port_bench" / "traffic" / "slq_logdet_small.json").write_text(json.dumps(SLQ_TRAFFIC))
	(copy / "port_bench" / "cells" / f"{cell}.json").write_text(json.dumps(LIMITS))
	bench = json.loads((copy / "BENCHMARK.json").read_text())
	bench["configs"].append({"name": cfg["name"], "source": cfg["source"],
		"file": f"port_bench/configs/{cfg['name']}.json", "reduced": [], "why": case["why"]})
	bench["workloads"].append({"name": cell, "config": cfg["name"], "traffic": "slq_logdet_small", "chips": 1,
		"why": "closed loop of one caller, log det from 16 probes x 12 Lanczos steps"})
	for m in bench["per_layer"]:
		if m["name"] in EVERY_CELLS:
			m["workloads"].append(cell)
	(copy / "BENCHMARK.json").write_text(json.dumps(bench, indent=2))
	return cell


def in_copy(copy, *args) -> subprocess.CompletedProcess:
	"""``python *args`` in the copy, which comes first on the path; the program from the repo."""
	env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(copy), str(harness.REPO)])}
	return subprocess.run([sys.executable, *args], cwd=copy, env=env, capture_output=True, text=True, timeout=900)


RUN = """
import json
from port_bench import harness
assert harness.ROOT.parent.samefile({copy!r})
print(json.dumps(harness.run_cell({cell!r}, 2**31 + 29, 0.2, False, device="cpu")))
"""


@pytest.mark.parametrize("kind", list(CASES))
def test_a_configuration_in_new_files_only(kind, tmp_path):
	copy = tmp_path / "checkout"
	copy.mkdir()
	shutil.copy(harness.REPO / "BENCHMARK.json", copy)
	shutil.copytree(harness.ROOT, copy / "port_bench", ignore=shutil.ignore_patterns("__pycache__"))
	before = files_of(copy)
	cell = add_configuration(copy, CASES[kind])

	p = in_copy(copy, "-c", RUN.format(copy=str(copy), cell=cell))
	assert p.returncode == 0, p.stderr[-4000:]
	r = json.loads(p.stdout.strip().splitlines()[-1])
	assert r["correct"] is True and r["failed"] == 0, r["checks"]
	assert {"setup_s", "estimate_s", "peak_mem_gb"} == set(r["metrics"])

	name = CASES[kind]["config"]["name"]
	select = f"{cell} or {name} or {CASES[kind]['config']['operator']} or every_operator"
	p = in_copy(copy, "-m", "pytest", "-q", "-p", "no:cacheprovider", "-p", "no:xdist", "-p", "no:randomly",
		"port_bench/tests", "-m", "not cuda", "-k", select)
	assert p.returncode == 0, p.stdout[-4000:]
	assert " passed" in p.stdout.strip().splitlines()[-1]

	after = files_of(copy)
	changed = sorted(rel for rel, data in before.items() if after.get(rel) != data)
	assert changed == ["BENCHMARK.json"]
	for rel in before:
		if rel != "BENCHMARK.json":
			assert (harness.REPO / rel).read_bytes() == after[rel], rel
	bench, mine = json.loads(after["BENCHMARK.json"]), json.loads(before["BENCHMARK.json"])
	for group in ("configs", "workloads"):
		assert bench[group][:-1] == mine[group] and len(bench[group]) == len(mine[group]) + 1
	for m in mine["per_layer"]:
		if m["name"] in EVERY_CELLS:
			m["workloads"].append(cell)
	assert {k: v for k, v in bench.items() if k not in ("configs", "workloads")} == {
		k: v for k, v in mine.items() if k not in ("configs", "workloads")}
