"""The least time of a call's recurrence on the device: each step reads the bands and two probe
blocks once and writes one block once, ``(3·nv·n + n_d·n)·itemsize`` bytes, at the device's
published memory bandwidth (``_peaks.json``). The work is the algorithm's, not a kernel's, so
fusing or splitting the passes of a step leaves the count as it is."""

import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).resolve().parent / "_peaks.json").read_text())


def step_bytes(nv: int, n: int, n_d: int, itemsize: int) -> int:
	return (3 * nv * n + n_d * n) * itemsize


def share_pct(run, kind: str):
	"""The call's least sweep time over its device busy time, in percent; None where the call runs
	no ``kind`` sweep, the run was not traced or the device has no entry in the table."""
	peak = PEAKS.get(run.device_kind, {}).get("hbm_bytes_per_s")
	if run.trace is None or run.sweep["kind"] != kind or peak is None or not run.trace.busy_ns or not run.completed:
		return None
	least_s = run.sweep["steps"] * step_bytes(run.sweep["nv"], run.n, run.n_d, run.itemsize) / peak
	return 100.0 * least_s / (run.trace.busy_ns / 1e9 / run.completed)
