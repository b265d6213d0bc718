"""The benchmark's harness: everything a run does between the command line and its last line.

A cell (an entry of ``workloads`` in ``BENCHMARK.json``) names a configuration and a traffic
file; the harness finds each by that name, and the cell's limits in ``cells/<cell>.json``, the
call the traffic names in ``calls/<call>.py``, the operator the configuration names in
``operators/<kind>.py`` (built in the configuration's ``format``, by ``FORMATS``) and each metric
in ``metrics/<metric>.py``. A run builds the operator on the device, warms the call up once,
repeats it in a closed loop of one caller for the window, then checks a sample of the window's
answers, drawn from the seed, against the plain reference.
"""

import contextlib
import gc
import importlib.util
import json
import sys
import time
import traceback
from pathlib import Path
from types import SimpleNamespace
from typing import Callable, NamedTuple

import numpy as np

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
# The warm-up call's index: no window reaches it, so its probes are none of the window's.
WARMUP_INDEX = 2**32


class Format(NamedTuple):
	"""How the harness builds an operator of one format: the operator module's function, which takes
	``(params, dtype, device)`` and returns the program's inputs built on the device; the port's
	constructor, which takes them as they come; and the operator's sizes, from the same inputs, that
	the metrics find on ``run``."""

	builder: str
	program: str
	sizes: Callable[..., dict]


# A configuration's ``format`` picks its row here.
FORMATS = {
	"dia": Format("bands", "DIAOperator", lambda bands, offsets, shape: dict(
		n=shape[0], n_d=len(offsets), itemsize=bands.element_size())),
	"bsr": Format("tiles", "BSROperator", lambda blocks, indices, indptr, shape: dict(
		n=shape[0], nnzb=blocks.shape[0], bm=blocks.shape[1], bn=blocks.shape[2], itemsize=blocks.element_size())),
	"csr": Format("entries", "CSROperator", lambda data, indices, indptr, shape: dict(
		n=shape[0], nnz=data.shape[0], itemsize=data.element_size())),
}


def operator_format(cfg: dict) -> Format:
	"""The row of ``FORMATS`` that the configuration's ``format`` names."""
	if cfg.get("format") not in FORMATS:
		raise KeyError(f"configuration {cfg.get('name')!r} names format {cfg.get('format')!r}; "
			f"the harness builds {sorted(FORMATS)}")
	return FORMATS[cfg["format"]]


def operator_inputs(cfg: dict, dtype, device) -> tuple:
	"""``(format, inputs)``: the configuration's row of ``FORMATS`` and what its operator module
	builds on the device for the port's constructor."""
	fmt = operator_format(cfg)
	return fmt, getattr(load_module("operators", cfg["operator"]), fmt.builder)(cfg["params"], dtype, device)


def log(**fields) -> None:
	"""One line of the run's account on standard output (the result line comes last)."""
	print(json.dumps(fields), flush=True)


def load_json(path: Path) -> dict:
	return json.loads(path.read_text())


def load_module(folder: str, name: str):
	"""``port_bench/<folder>/<name>.py``; a name may hold dots."""
	path = ROOT / folder / f"{name}.py"
	if not path.is_file():
		raise KeyError(f"no {folder} module {name!r} (looked for {path})")
	importlib.import_module(f"port_bench.{folder}")
	spec = importlib.util.spec_from_file_location(f"port_bench.{folder}.{name}", path)
	mod = importlib.util.module_from_spec(spec)
	mod.__package__ = f"port_bench.{folder}"
	spec.loader.exec_module(mod)
	return mod


def by_name(entries: list, name: str, what: str) -> dict:
	for e in entries:
		if e["name"] == name:
			return e
	raise KeyError(f"BENCHMARK.json has no {what} {name!r}")


def call_seed(seed: int, i: int) -> int:
	"""The seed of call ``i`` of a run seeded ``seed``."""
	return int(np.random.SeedSequence([int(seed) % 2**64, i]).generate_state(1, np.uint64)[0] >> np.uint64(1))


def applies(metric: dict, cell: str) -> bool:
	return "workloads" not in metric or cell in metric["workloads"]


def sync(device) -> None:
	if device.type == "cuda":
		import torch

		torch.cuda.synchronize(device)


class Cell:
	"""A cell's files, its program side and its reference side. ``params`` overrides the
	configuration's sizes (the tests' small lattices); ``control`` puts the configuration's
	lower-precision control in the program's place."""

	def __init__(self, name: str, device, params: dict = None, control: bool = False, bench: dict = None):
		import torch

		self.bench = bench or load_json(REPO / "BENCHMARK.json")
		self.name = name
		self.workload = by_name(self.bench["workloads"], name, "workload")
		self.cfg = load_json(REPO / by_name(self.bench["configs"], self.workload["config"], "config")["file"])
		self.cfg["params"] = {**self.cfg["params"], **(params or {})}
		self.traffic = load_json(ROOT / "traffic" / f"{self.workload['traffic']}.json")
		self.limits = load_json(ROOT / "cells" / f"{name}.json")
		self.call = load_module("calls", self.traffic["call"])
		self.device = torch.device(device)
		self.control = self.cfg["control"] if control else {}
		self.dtype = getattr(torch, self.control.get("program_dtype", self.cfg["dtype"]))

	def build(self, ptt) -> None:
		"""The program's operator in the configuration's format, from inputs built on the device, and
		the call on it."""
		from . import reference

		fmt, parts = operator_inputs(self.cfg, self.dtype, self.device)
		self.sizes = fmt.sizes(*parts)
		if "reference_precision" in self.control:
			ref = reference.operator(self.cfg, self.control["reference_precision"], self.device)
			self.fn = lambda seed: self.call.reference(ref, self.traffic, seed)
			return
		self.op = getattr(ptt, fmt.program)(*parts)
		self.fn = self.call.program(ptt, self.op, self.traffic)

	def faults(self) -> dict:
		"""The faults this cell's timed path can have, by name: planters that take a ``setattr``."""
		return self.call.faults(self.traffic, max(self.limits["limits"].values()))

	def free(self) -> None:
		"""Drop the program's state, so that the reference has the device to itself."""
		import torch

		self.fn = self.op = None
		gc.collect()
		if self.device.type == "cuda":
			torch.cuda.empty_cache()

	def checked(self, seed: int, ok: list) -> list:
		"""The indices of the window's calls whose answers are checked: a sample drawn from the seed."""
		k = min(int(self.limits["checked_calls"]), len(ok))
		rng = np.random.default_rng([int(seed) % 2**64, 1])
		return sorted(int(i) for i in rng.choice(ok, size=k, replace=False)) if k else []

	def check(self, seed: int, outputs: dict) -> dict:
		"""The largest of each compared number over the answers ``{call index: answer}``."""
		from . import reference

		ref = reference.operator(self.cfg, "float64", self.device)
		worst = {}
		for i, got in outputs.items():
			for key, v in self.call.compare(got, self.call.reference(ref, self.traffic, call_seed(seed, i))).items():
				worst[key] = max(worst.get(key, v), v) if np.isfinite(v) else float("nan")
		return worst


def window(cell: Cell, seed: int, seconds: float, traced: bool):
	"""The closed loop: call after call until ``seconds`` have passed, at least one. Returns the
	walls, the answers (None for a call that raised), the window's length and the profiler."""
	walls, outputs, prof = [], [], None
	with contextlib.ExitStack() as stack:
		if traced:
			from torch.profiler import ProfilerActivity, profile, record_function

			from .metrics._trace import WINDOW

			acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cell.device.type == "cuda" else [])
			prof = stack.enter_context(profile(activities=acts))
			stack.enter_context(record_function(WINDOW))
		t_win = time.perf_counter()
		while not walls or time.perf_counter() - t_win < seconds:
			t0 = time.perf_counter()
			try:
				out = cell.fn(call_seed(seed, len(walls)))
				sync(cell.device)
			except Exception:  # a call that raises is a failed operation; the window goes on
				traceback.print_exc(file=sys.stderr)
				out = None
			walls.append(time.perf_counter() - t0)
			outputs.append(out)
		window_s = time.perf_counter() - t_win
	return walls, outputs, window_s, prof


def run_cell(name: str, seed: int, seconds: float, traced: bool, device="cuda", t_start: float = None,
	params: dict = None, bench: dict = None) -> dict:
	"""One run of a cell; returns the result line's object, ``checks`` last."""
	import torch

	t_start = time.perf_counter() if t_start is None else t_start
	cell = Cell(name, device, params=params, bench=bench)
	marks = [time.perf_counter()]
	import primate_tpu_torch as ptt
	from primate_tpu_torch.ops import _common

	marks.append(time.perf_counter())
	cell.build(ptt)
	sync(cell.device)
	marks.append(time.perf_counter())
	cell.fn(call_seed(seed, WARMUP_INDEX))
	sync(cell.device)
	marks.append(time.perf_counter())
	setup_s = marks[-1] - t_start
	log(setup_parts_s=dict(zip(("torch_and_files", "program_import", "operator_build", "warmup_call"), np.diff([t_start, *marks]).tolist())))
	cuda = cell.device.type == "cuda"
	setup_peak = torch.cuda.max_memory_allocated(cell.device) if cuda else 0
	if cuda:
		torch.cuda.reset_peak_memory_stats(cell.device)
	_common.reset_launches()

	walls, outputs, window_s, prof = window(cell, seed, seconds, traced)

	window_peak = torch.cuda.max_memory_allocated(cell.device) if cuda else 0
	ok = [i for i, out in enumerate(outputs) if out is not None]
	log(launches=dict(_common.LAUNCHES), layout_copies=dict(_common.LAYOUT_COPIES), scalar_launches=dict(_common.SCALAR_LAUNCHES))
	log(walls_s=walls, window_s=window_s, setup_s=setup_s)
	trace = None
	if prof is not None:
		from .metrics import _trace

		t0 = time.perf_counter()
		trace = _trace.from_events(prof.profiler.kineto_results.events())
		prof = None
		log(trace_read_s=time.perf_counter() - t0, device_ops=len(trace.device), kernels=len(trace.kernels),
			host_ops=len(trace.host), kinds=sorted({k for _, k, _, _ in trace.device}))
	cell.free()

	t0 = time.perf_counter()
	checked = cell.checked(seed, ok)
	numbers = cell.check(seed, {i: outputs[i] for i in checked})
	log(reference_s=time.perf_counter() - t0, checked_calls=checked)
	limits = cell.limits["limits"]
	checks = {k: {"value": numbers.get(k, float("nan")), "limit": limits[k]} for k in limits}
	correct = len(ok) == len(outputs) and bool(checked) and all(c["value"] <= c["limit"] for c in checks.values())

	kind = torch.cuda.get_device_name(cell.device) if cuda else "cpu"
	run = SimpleNamespace(setup_s=setup_s, walls=walls, window_s=window_s, completed=len(ok), window_peak_bytes=window_peak,
		trace=trace, sweep=cell.call.sweep(cell.traffic), device_kind=kind,
		program_dir=Path(ptt.__file__).resolve().parent, **cell.sizes)
	metrics = {}
	for m in cell.bench["per_layer" if traced else "end_to_end"]:
		if applies(m, name):
			v = load_module("metrics", m["name"]).read(run)
			if v is not None:
				metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
	dev = {"platform": "gpu" if cuda else "cpu", "kind": kind, "count": int(cell.workload["chips"]),
		"memory_peak_bytes": int(max(setup_peak, window_peak))}
	if trace is not None:
		dev.update(busy_s=trace.busy_ns / 1e9, window_s=trace.window_ns / 1e9)
	result = {"correct": correct, "attempted": len(outputs), "failed": len(outputs) - len(ok), "metrics": metrics, "device": dev}
	if trace is not None:
		result["breakdown"] = trace.breakdown()
	result["checks"] = checks
	return result
