"""A profiled window reduced to what the metrics read: device operations and host operations as
``(name, start_ns, end_ns)`` intervals, clipped to the window, and their arithmetic.

Busy time is the length of the union of the device operations' intervals, so two operations that
overlap count once; idle is the window less that union. The program's own kernels are the
``__global__`` functions of its ``csrc/`` sources and the ``@triton.jit`` functions of its Python
modules, found by name when the run reads them, so a kernel added or renamed is counted as the
program's without an edit here.
"""

import re
from pathlib import Path

WINDOW = "port_bench.window"
_GLOBAL = re.compile(r"__global__\s+(?:void\s+)?(?:__launch_bounds__\s*\((?:[^()]|\([^()]*\))*\)\s*)?(?:void\s+)?([A-Za-z_]\w*)\s*\(")
_TRITON = re.compile(r"@triton\.jit[^\n]*\n(?:\s*@[^\n]*\n)*\s*def\s+([A-Za-z_]\w*)")
_IDENT = re.compile(r"[A-Za-z_]\w*")


def union(intervals) -> list:
	"""The disjoint ``(start, end)`` intervals that cover ``intervals``, in order."""
	merged = []
	for s, e in sorted(intervals):
		if merged and s <= merged[-1][1]:
			merged[-1][1] = max(merged[-1][1], e)
		else:
			merged.append([s, e])
	return [(s, e) for s, e in merged]


def covered(intervals) -> int:
	return sum(e - s for s, e in union(intervals))


def port_kernel_names(program_dir: Path) -> set:
	"""The names of the program's own kernels, read from its sources."""
	names = set()
	for src in [*program_dir.glob("**/*.cu"), *program_dir.glob("**/*.cuh")]:
		names.update(_GLOBAL.findall(src.read_text(errors="replace")))
	for src in program_dir.glob("**/*.py"):
		text = src.read_text(errors="replace")
		if "triton.jit" in text:
			names.update(_TRITON.findall(text))
	return names


def is_port_kernel(name: str, names: set) -> bool:
	return not names.isdisjoint(_IDENT.findall(name))


def short_name(name: str) -> str:
	"""A kernel's name without its return type and argument list, at most 120 characters."""
	name = name.replace("(anonymous namespace)::", "").removeprefix("void ")
	depth = 0
	for i, ch in enumerate(name):
		depth += (ch == "<") - (ch == ">")
		if ch == "(" and depth == 0 and i > 0:
			if "<" in name[:i] or "::" in name[:i]:
				name = name[:i]
			break
	return name[:120]


class Trace:
	"""``device``: ``(name, kind, start_ns, end_ns)`` of each operation on the device (``kind`` the
	profiler's activity, such as ``"kernel"`` or ``"gpu_memcpy"``); ``host``: ``(name, start_ns,
	end_ns)`` of each host operation; ``window``: ``(start_ns, end_ns)``."""

	def __init__(self, device, host, window):
		w0, w1 = window
		self.window = window
		self.window_ns = w1 - w0
		self.device = [(n, k, max(s, w0), min(e, w1)) for n, k, s, e in device if e > w0 and s < w1]
		self.kernels = [op for op in self.device if op[1] == "kernel"]
		# by start, and at one start the longer (outer) operation first, as the gaps' attribution walks them
		self.host = sorted((s, -e, n) for n, s, e in host if e > w0 and s < w1)
		self.busy = union((s, e) for _, _, s, e in self.device)
		self.busy_ns = sum(e - s for s, e in self.busy)

	def gaps(self) -> list:
		"""The idle ``(start, end)`` intervals of the window."""
		out, t = [], self.window[0]
		for s, e in self.busy:
			if s > t:
				out.append((t, s))
			t = max(t, e)
		if self.window[1] > t:
			out.append((t, self.window[1]))
		return out

	def idle_by_host(self) -> dict:
		"""Idle nanoseconds by the innermost host operation running at each gap's midpoint
		(``"(no host op)"`` where none is)."""
		mids = sorted(((s + e) // 2, e - s) for s, e in self.gaps())
		stack, i, total = [], 0, {}
		for mid, length in mids:
			while i < len(self.host) and self.host[i][0] <= mid:
				s, neg_e, name = self.host[i]
				while stack and stack[-1][0] <= s:
					stack.pop()
				stack.append((-neg_e, name))
				i += 1
			while stack and stack[-1][0] < mid:
				stack.pop()
			name = stack[-1][1] if stack else "(no host op)"
			total[name] = total.get(name, 0) + length
		return total

	def device_time_by_name(self) -> dict:
		total = {}
		for name, _, s, e in self.device:
			key = short_name(name)
			total[key] = total.get(key, 0) + (e - s)
		return total

	def breakdown(self, top: int = 10) -> dict:
		def head(d):
			return [[k, v / 1e9] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]

		return {"device_ops": head(self.device_time_by_name()), "idle_gaps": head(self.idle_by_host())}


def _kind(e, annotations: set) -> str:
	"""The profiler's activity of a raw device event, read from its name: this PyTorch's raw events
	carry no activity type, copies and fills are named so, and an annotation repeats a host event's name."""
	name = e.name()
	if name in annotations:
		return "gpu_user_annotation"
	return "gpu_memcpy" if name.startswith("Memcpy") else "gpu_memset" if name.startswith("Memset") else "kernel"


def _span(e) -> tuple:
	return e.start_ns(), e.start_ns() + e.duration_ns()


def from_events(events) -> Trace:
	"""The reduced trace of the profiler's raw events (``prof.profiler.kineto_results.events()``) of a
	window the harness marked with a host annotation named :data:`WINDOW`."""
	from torch.autograd import DeviceType

	on_host = [e for e in events if e.device_type() == DeviceType.CPU]
	names = {e.name() for e in on_host}
	marks = [e for e in on_host if e.name() == WINDOW]
	if not marks:
		raise RuntimeError(f"the profiled window has no {WINDOW!r} annotation")
	mark = marks[0]
	thread = mark.start_thread_id()
	device = []
	for e in events:
		if e.device_type() != DeviceType.CPU:
			kind = _kind(e, names)
			if kind != "gpu_user_annotation":
				device.append((e.name(), kind, *_span(e)))
	# the harness's thread only: its operations nest, which the attribution of gaps relies on
	host = [(e.name(), *_span(e)) for e in on_host if e is not mark and e.start_thread_id() == thread]
	return Trace(device, host, _span(mark))
