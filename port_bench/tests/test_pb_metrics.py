"""Each metric's arithmetic on hand-made traces."""

from pathlib import Path
from types import SimpleNamespace

import pytest

from port_bench import harness
from port_bench.metrics import _roofline, _trace

MS = 1_000_000  # nanoseconds


def metric(name):
	return harness.load_module("metrics", name).read


def test_union_counts_overlaps_once():
	assert _trace.union([(5, 9), (0, 3), (2, 4), (8, 12), (20, 21)]) == [(0, 4), (5, 12), (20, 21)]
	assert _trace.covered([(0, 10), (2, 3), (5, 15)]) == 15
	assert _trace.covered([]) == 0


def make_trace():
	# window 0-100 ms; a port kernel 10-40, a torch kernel 30-50 (overlapping it), a memcpy 60-70,
	# an operation outside the window, cut at its edge
	device = [
		("void lanczos_pass_a_kernel<float, 4>(float const*, int)", "kernel", 10 * MS, 40 * MS),
		("void at::native::vectorized_elementwise_kernel<4, at::native::AddFunctor<float>>(int)", "kernel", 30 * MS, 50 * MS),
		("Memcpy DtoH (Device -> Pinned)", "gpu_memcpy", 60 * MS, 70 * MS),
		("dia_stencil_t_kernel", "kernel", 95 * MS, 130 * MS),
	]
	host = [("aten::add_", 45 * MS, 58 * MS), ("call", 0, 100 * MS), ("cudaStreamSynchronize", 71 * MS, 94 * MS), ("aten::sub_", 52 * MS, 54 * MS)]
	return _trace.Trace(device, host, (0, 100 * MS))


def test_trace_busy_gaps_and_host_attribution():
	t = make_trace()
	assert t.busy_ns == (40 + 10 + 5) * MS
	assert t.gaps() == [(0, 10 * MS), (50 * MS, 60 * MS), (70 * MS, 95 * MS)]
	idle = t.idle_by_host()
	# gap 0-10 (midpoint 5): only "call" covers it; 50-60 (55): aten::sub_ ends there, aten::add_ is
	# innermost at 55; 70-95 (82.5): the synchronise
	assert idle == {"call": 10 * MS, "aten::add_": 10 * MS, "cudaStreamSynchronize": 25 * MS}
	b = t.breakdown()
	assert b["device_ops"][0] == ["lanczos_pass_a_kernel<float, 4>", 0.03]
	assert [name for name, _ in b["idle_gaps"]] == ["cudaStreamSynchronize", "call", "aten::add_"]


def test_short_names():
	assert _trace.short_name("void (anonymous namespace)::lanczos_pass_a_kernel<float, 4>(float const*, long)") == (
		"lanczos_pass_a_kernel<float, 4>")
	name = ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float, at::native::func_wrapper_t<float, "
		"at::native::sum_functor<float>::operator()(at::TensorIterator&)::{lambda(float, float)#1}>>>(at::native::ReduceOp<float>)")
	assert _trace.short_name(name) == name.removeprefix("void ")[:120]
	assert _trace.short_name("Memset (Device)") == "Memset (Device)"
	assert _trace.short_name("syevbj_batch_32x16<float>(int, float*)") == "syevbj_batch_32x16<float>"


def test_port_kernel_names_read_from_sources(tmp_path):
	import primate_tpu_torch

	names = _trace.port_kernel_names(Path(primate_tpu_torch.__file__).resolve().parent)
	assert {"dia_stencil_t_kernel", "lanczos_pass_a_kernel", "lanczos_pass_b_kernel", "bsr_spmm_kernel"} <= names
	(tmp_path / "k.cu").write_text("template <int B>\n__global__ void __launch_bounds__(kT, f(B)) fresh_kernel(float* x) {}\n")
	(tmp_path / "t.py").write_text("import triton\n@triton.jit\ndef fused_step(x_ptr, n):\n    pass\n")
	assert _trace.port_kernel_names(tmp_path) == {"fresh_kernel", "fused_step"}
	assert _trace.is_port_kernel("void fresh_kernel<4>(float*)", {"fresh_kernel"})
	assert not _trace.is_port_kernel("void at::native::fresh_kernel_v2(float*)", {"fresh_kernel"})


def make_run(trace, tmp_path, kind="lanczos", completed=2):
	(tmp_path / "a.cu").write_text("__global__ void lanczos_pass_a_kernel(float* x) {}\n__global__ void dia_stencil_t_kernel(float* x) {}\n")
	return SimpleNamespace(setup_s=7.5, walls=[0.1, 0.2, 0.3, 0.4], window_s=1.0, completed=completed, window_peak_bytes=3e9,
		trace=trace, sweep={"kind": kind, "steps": 20, "nv": 64}, n=10_000_000, n_d=3, itemsize=4,
		device_kind="NVIDIA H100 80GB HBM3", program_dir=tmp_path)


def test_host_clock_metrics(tmp_path):
	run = make_run(None, tmp_path, completed=4)
	assert metric("setup_s")(run) == 7.5
	assert metric("estimate_s")(run) == 0.25
	assert metric("estimate_p95_s")(run) == pytest.approx(0.385)
	assert metric("peak_mem_gb")(run) == 3.0
	run.completed = 0
	assert metric("estimate_s")(run) is None


def test_trace_metrics(tmp_path):
	run = make_run(make_trace(), tmp_path)
	assert metric("launches_per_estimate")(run) == 1.5  # three kernels, two estimates
	# the torch kernel's 30-50 ms alone, over two estimates
	assert metric("torch_kernel_ms")(run) == pytest.approx(10.0)
	assert metric("device_idle_pct")(run) == pytest.approx(45.0)
	least = 20 * (3 * 64 * 10_000_000 + 3 * 10_000_000) * 4 / 3.35e12
	assert metric("lanczos_sweep_roofline")(run) == pytest.approx(100 * least / 0.0275)
	assert metric("chebyshev_sweep_roofline")(run) is None


def test_nothing_to_read_gives_none(tmp_path):
	run = make_run(None, tmp_path)
	for name in ("launches_per_estimate", "torch_kernel_ms", "device_idle_pct", "lanczos_sweep_roofline", "chebyshev_sweep_roofline"):
		assert metric(name)(run) is None
	run = make_run(make_trace(), tmp_path)
	run.device_kind = "an unlisted device"
	assert metric("lanczos_sweep_roofline")(run) is None


def test_step_bytes():
	# the Hofstadter cell's Chebyshev step: 16 complex64 probes over 4,096,000 sites and 8 bands
	assert _roofline.step_bytes(16, 4_096_000, 8, 8) == (3 * 16 + 8) * 4_096_000 * 8


class Event:
	"""A raw profiler event of a PyTorch whose events carry no activity type."""

	def __init__(self, name, device, start, dur, thread=1):
		self._v = (name, device, start, dur, thread)

	def name(self):
		return self._v[0]

	def device_type(self):
		return self._v[1]

	def start_ns(self):
		return self._v[2]

	def duration_ns(self):
		return self._v[3]

	def start_thread_id(self):
		return self._v[4]


def test_raw_events_without_activity_types():
	from torch.autograd import DeviceType

	cpu, gpu = DeviceType.CPU, DeviceType.CUDA
	t = _trace.from_events([
		Event(_trace.WINDOW, cpu, 0, 100), Event("aten::mul", cpu, 5, 10), Event("aten::mul", cpu, 6, 10, thread=2),
		Event(_trace.WINDOW, gpu, 0, 100), Event("void k<1>(float*)", gpu, 10, 20), Event("Memcpy HtoD", gpu, 40, 5),
		Event("Memset (Device)", gpu, 50, 5),
	])
	assert t.window == (0, 100) and [op[1] for op in t.device] == ["kernel", "gpu_memcpy", "gpu_memset"]
	assert len(t.kernels) == 1 and t.busy_ns == 30 and t.host == [(5, -15, "aten::mul")]
