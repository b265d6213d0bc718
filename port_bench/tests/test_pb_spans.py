"""The program's spans in a traced window (``metrics/_spans.py``) and the four metrics that read them:
the arithmetic on a hand-made trace, whole runs on the CPU at small sizes, and on the card the
spans, the runtime calls and the device's operations on one clock."""

import json
import re

import pytest

from port_bench import harness
from port_bench.metrics import _spans, _trace

from .conftest import BENCH, CELLS, run_tiny
from .test_pb_metrics import MS, make_run, make_trace

NEW = ("sweep_idle_ms", "quadrature_idle_ms", "estimator_idle_ms", "host_syncs_per_estimate")
OLD = ("launches_per_estimate", "torch_kernel_ms", "lanczos_sweep_roofline", "chebyshev_sweep_roofline", "device_idle_pct")


def metric(name):
	return harness.load_module("metrics", name).read


def span_trace():
	# window 0-100 ms: an estimate 5-90 holding a sweep 10-40 and a quadrature 50-70; the device busy
	# 15-45 (across the sweep's end), 55-65, 82-85 (a copy to the host) and 93-97
	device = [
		("lanczos_pass_a_kernel", "kernel", 15 * MS, 45 * MS),
		("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 21 * MS, 22 * MS),
		("at::native::reduce_kernel", "kernel", 55 * MS, 65 * MS),
		("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 82 * MS, 85 * MS),
		("at::native::fill_kernel", "kernel", 93 * MS, 97 * MS),
	]
	host = [
		("primate.estimate", 5 * MS, 90 * MS), ("primate.sweep", 10 * MS, 40 * MS), ("aten::mul", 12 * MS, 13 * MS),
		("cudaLaunchKernel", 14 * MS, 15 * MS), ("cudaMemcpyAsync", 20 * MS, 21 * MS),
		("primate.quadrature", 50 * MS, 70 * MS), ("cudaLaunchKernel", 54 * MS, 55 * MS), ("cudaStreamSynchronize", 60 * MS, 68 * MS),
		("cudaMemcpyAsync", 80 * MS, 81 * MS), ("cudaStreamSynchronize", 81 * MS, 86 * MS),  # a readback
		("cudaLaunchKernel", 92 * MS, 92 * MS + 1), ("cudaDeviceSynchronize", 92 * MS + 2, 95 * MS),
	]
	return _trace.Trace(device, host, (0, 100 * MS))


def test_idle_cut_at_span_edges_adds_up_to_the_window_less_busy():
	t = span_trace()
	assert t.busy_ns == 47 * MS
	parts = _spans.idle_ns(t, _spans.program_spans(t))
	# gap 0-15 is cut at 5 and 10: 5 outside, 5 in the estimate, 5 in the sweep; 45-55 at 50; 65-82 at
	# 70; 85-93 at 90; 97-100 is outside
	assert parts == {_spans.OUTSIDE: 11 * MS, "primate.estimate": 27 * MS, "primate.sweep": 5 * MS, "primate.quadrature": 10 * MS}
	assert sum(parts.values()) == t.window_ns - t.busy_ns


def test_innermost_span_at_points_and_edges():
	t = span_trace()
	spans = _spans.program_spans(t)
	assert [n for _, _, n in spans] == ["primate.estimate", "primate.sweep", "primate.quadrature"]
	points = [0, 5 * MS, 10 * MS, 40 * MS - 1, 40 * MS, 50 * MS, 70 * MS, 90 * MS - 1, 90 * MS]
	assert _spans.innermost(points, spans) == [_spans.OUTSIDE, "primate.estimate", "primate.sweep", "primate.sweep",
		"primate.estimate", "primate.quadrature", "primate.estimate", "primate.estimate", _spans.OUTSIDE]


def test_synchronise_and_launch_calls_by_span(tmp_path):
	t = span_trace()
	assert _spans.starts(t, _spans.SYNCS) == [60 * MS, 81 * MS, 92 * MS + 2]
	run = make_run(t, tmp_path, completed=2)
	parts = _spans.split(run)
	assert {n: p["syncs"] for n, p in parts.items()} == {
		"primate.estimate": 1, "primate.quadrature": 1, "primate.sweep": 0, _spans.OUTSIDE: 1}
	assert {n: p["launches"] for n, p in parts.items()} == {
		"primate.estimate": 0, "primate.quadrature": 1, "primate.sweep": 1, _spans.OUTSIDE: 1}
	assert {n: p["count"] for n, p in parts.items()} == {
		"primate.estimate": 1, "primate.quadrature": 1, "primate.sweep": 1, _spans.OUTSIDE: 0}


def test_span_metrics(tmp_path, capsys):
	run = make_run(span_trace(), tmp_path, completed=2)
	assert metric("sweep_idle_ms")(run) == pytest.approx(2.5)
	assert metric("quadrature_idle_ms")(run) == pytest.approx(5.0)
	assert metric("estimator_idle_ms")(run) == pytest.approx(13.5)
	assert metric("host_syncs_per_estimate")(run) == 1.0  # the rule's and the readback's; not the harness's
	lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
	assert len(lines) == 1  # worked out and logged once a run
	assert sum(lines[0]["span_idle_ns"].values()) == lines[0]["window_idle_ns"] == 53 * MS


def test_nothing_to_read_gives_none(tmp_path):
	runs = [make_run(None, tmp_path), make_run(make_trace(), tmp_path)]  # untraced; a program that opens no span
	no_device = span_trace()
	no_device.device = []
	runs.append(make_run(no_device, tmp_path))
	for run in runs:
		assert all(metric(name)(run) is None for name in NEW)


def test_spans_move_none_of_the_older_metrics(tmp_path):
	bare = make_trace()
	extra = [("primate.estimate", 0, 99 * MS), ("primate.sweep", 5 * MS, 42 * MS), ("primate.quadrature", 44 * MS, 60 * MS)]
	spanned = _trace.Trace(bare.device, [(n, s, -neg_e) for s, neg_e, n in bare.host] + extra, bare.window)
	for name in OLD:
		assert metric(name)(make_run(bare, tmp_path)) == metric(name)(make_run(spanned, tmp_path)), name
	assert bare.breakdown()["device_ops"] == spanned.breakdown()["device_ops"]


# (estimate, sweep, quadrature) spans a call of each cell opens; the call of a traffic not listed here
# opens at least its estimate's span
CALL_SPANS = {"slq_logdet": (1, 1, 1), "slq_logdet_orth5": (1, 1, 1), "kpm_dos": (1, 1, 1), "slq_dos": (1, 1, 2)}


@pytest.mark.parametrize("cell", CELLS)
def test_tiny_traced_run_splits_its_idle_to_the_nanosecond(cell, capsys):
	r = run_tiny(cell, traced=True)
	assert r["correct"] is True
	lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
	split = [line for line in lines if "spans_per_estimate" in line]
	assert len(split) == 1
	split = split[0]
	assert sum(split["span_idle_ns"].values()) == split["window_idle_ns"]
	per = split["spans_per_estimate"]
	counts = tuple(per.get(f"primate.{k}", {}).get("count", 0) for k in ("estimate", "sweep", "quadrature"))
	traffic = harness.by_name(BENCH["workloads"], cell, "workload")["traffic"]
	if traffic in CALL_SPANS:
		assert counts == CALL_SPANS[traffic]
	else:
		assert counts[0] >= 1
	assert not set(NEW) & set(r["metrics"])  # no device operation on the CPU: nothing to read


LAUNCH = re.compile(r"cu(da)?(Launch|Memcpy|Memset)")


@pytest.mark.cuda
def test_spans_launches_and_kernels_share_one_clock_on_the_card(cuda_device, capsys):
	"""A small traced flagship: the four metrics read, the idle parts add up, and in the raw events
	each kernel finds the runtime call that launched it by correlation id, starts after it, and the
	kernels launched inside ``primate.sweep`` take at most the window's busy time."""
	import primate_tpu_torch as ptt
	from torch.profiler import ProfilerActivity, profile, record_function

	r = harness.run_cell("slq_logdet.path10M", 2**31 + 91, 2.0, True, device="cuda", params={"n": 1_000_000}, bench=BENCH)
	assert r["correct"] is True and set(NEW) <= set(r["metrics"])
	split = [json.loads(line) for line in capsys.readouterr().out.splitlines() if "spans_per_estimate" in line][0]
	assert sum(split["span_idle_ns"].values()) == split["window_idle_ns"]

	cell = harness.Cell("slq_logdet.path10M", "cuda", params={"n": 1_000_000})
	cell.build(ptt)
	cell.fn(1)
	harness.sync(cell.device)
	with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
		with record_function(_trace.WINDOW):
			for i in range(3):
				cell.fn(100 + i)
				harness.sync(cell.device)
	events = prof.profiler.kineto_results.events()
	t = _trace.from_events(events)
	from torch.autograd import DeviceType

	host = [e for e in events if e.device_type() == DeviceType.CPU]
	thread = next(e for e in host if e.name() == _trace.WINDOW).start_thread_id()
	launches = {e.correlation_id(): e.start_ns() for e in host
		if e.start_thread_id() == thread and LAUNCH.match(e.name()) and e.correlation_id()}
	names = {e.name() for e in host}
	w0, w1 = t.window
	ops = [e for e in events if e.device_type() != DeviceType.CPU and _trace._kind(e, names) != "gpu_user_annotation"
		and w0 < e.start_ns() < w1]
	kernels = [e for e in ops if _trace._kind(e, names) == "kernel"]
	paired = [e for e in ops if e.correlation_id() in launches]
	share = sum(e.correlation_id() in launches for e in kernels) / len(kernels)
	assert share >= 0.99, (share, len(kernels))
	early = [(e.name(), launches[e.correlation_id()] - e.start_ns()) for e in paired if e.start_ns() < launches[e.correlation_id()] - 10_000]
	assert not early, early[:5]
	spans = _spans.program_spans(t)
	paired.sort(key=lambda e: launches[e.correlation_id()])
	where = _spans.innermost([launches[e.correlation_id()] for e in paired], spans)
	sweep_ns = _trace.covered([(e.start_ns(), e.start_ns() + e.duration_ns()) for e, name in zip(paired, where) if name == "primate.sweep"])
	assert 0 < sweep_ns <= t.busy_ns
