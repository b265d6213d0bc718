"""The program's spans in a traced window, and the device's idle time, the synchronise calls and
the kernel launch calls split among them.

A program span is a host operation on the harness's thread whose name starts with ``primate.``
(the port opens ``primate.estimate``, ``primate.sweep`` and ``primate.quadrature`` through
``utils.profiling.annotate`` while a profiler runs); on one thread they nest. Each gap of the
device (``Trace.gaps()``) is cut at every span's start and end, and each piece goes to the
innermost span open over it, else to ``(outside)``: the harness between calls, or a program that
opens no span. So the parts add up to the window less its busy time, to the nanosecond.

A synchronise (``cudaStreamSynchronize``, ``cudaDeviceSynchronize``, ``cudaEventSynchronize``)
and a launch call (``cudaLaunchKernel``, ``cuLaunchKernel`` and their ``Ex`` forms) on the harness's
thread go to the innermost span open when they began. PyTorch ends each readback (``.item()``, ``.cpu()``) and each copy from pageable memory with
one, so the count is one a readback. The copy calls themselves are not counted: whether the copy
runs while its call is on the host depends on the queue, and the reduced trace keeps no
correlation ids to tell a copy to the host from another. For the same reason a device operation
is not paired with the call that launched it here, and no device time is split by span.
"""

import bisect
import itertools

from ..harness import log

PREFIX = "primate."
OUTSIDE = "(outside)"
SYNCS = frozenset(("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize"))
LAUNCHES = frozenset(("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx"))


def program_spans(trace) -> list:
	"""``(start_ns, end_ns, name)`` of each program span, by start and at one start the outer first."""
	return [(s, -neg_e, name) for s, neg_e, name in trace.host if name.startswith(PREFIX)]


def innermost(points, spans) -> list:
	"""The name of the innermost of ``spans`` (nested, in :func:`program_spans`' order) open at
	each of ``points`` (ascending), or ``OUTSIDE``. A span is open over ``[start, end)``."""
	names, stack, i = [], [], 0
	for t in points:
		while i < len(spans) and spans[i][0] <= t:
			s, e, name = spans[i]
			while stack and stack[-1][0] <= s:
				stack.pop()
			stack.append((e, name))
			i += 1
		while stack and stack[-1][0] <= t:
			stack.pop()
		names.append(stack[-1][1] if stack else OUTSIDE)
	return names


def idle_ns(trace, spans) -> dict:
	"""Idle nanoseconds of the window by the innermost span open over them."""
	edges = sorted({t for s, e, _ in spans for t in (s, e)})
	pieces = []
	for a, b in trace.gaps():
		cuts = [a, *edges[bisect.bisect_right(edges, a):bisect.bisect_left(edges, b)], b]
		pieces.extend(itertools.pairwise(cuts))
	total = {}
	for (a, b), name in zip(pieces, innermost([(a + b) // 2 for a, b in pieces], spans)):
		total[name] = total.get(name, 0) + (b - a)
	return total


def starts(trace, names) -> list:
	"""The start of each host operation on the harness's thread named one of ``names``, ascending."""
	return [s for s, _, name in trace.host if name in names]


def split(run):
	"""``{name: {"count", "idle_ns", "syncs", "launches"}}`` over the program's span names and
	``(outside)`` (``count`` the spans of that name in the window), or None where the run was not traced or the
	program opened no span. Worked out once a run and logged as a line of its account, per estimate
	beside the window's totals."""
	if run.trace is None:
		return None
	if getattr(run, "span_split", None) is None:
		spans = program_spans(run.trace)
		if not spans:
			return None
		parts = {name: dict.fromkeys(("count", "idle_ns", "syncs", "launches"), 0) for name in
			[*sorted({n for _, _, n in spans}), OUTSIDE]}
		for _, _, name in spans:
			parts[name]["count"] += 1
		for name, ns in idle_ns(run.trace, spans).items():
			parts[name]["idle_ns"] = ns
		for key, names in (("syncs", SYNCS), ("launches", LAUNCHES)):
			for name in innermost(starts(run.trace, names), spans):
				parts[name][key] += 1
		run.span_split = parts
		_log(run, parts)
	return run.span_split


def _log(run, parts: dict) -> None:
	per = max(run.completed, 1)
	log(spans_per_estimate={name: {"count": p["count"] / per, "idle_ms": p["idle_ns"] / 1e6 / per,
		"syncs": p["syncs"] / per, "launches": p["launches"] / per} for name, p in parts.items()},
		span_idle_ns={name: p["idle_ns"] for name, p in parts.items()},
		window_idle_ns=run.trace.window_ns - run.trace.busy_ns, estimates=run.completed)


def idle_ms(run, name: str):
	"""Idle device ms an estimate inside ``name`` and in none of its child spans; None where the run
	has nothing to read there."""
	parts = split(run)
	if parts is None or name not in parts or not run.trace.device or not run.completed:
		return None
	return parts[name]["idle_ns"] / 1e6 / run.completed
