"""The port's spans (``utils.profiling.annotate``): which a call opens under ``torch.profiler``, how
they nest, and that they cost no record and change no number when no profiler runs."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import primate_tpu_torch as ptt
from primate_tpu_torch import recipes
from primate_tpu_torch.utils.profiling import annotate

N = 1500


def _path(n: int = N):
	bands = torch.stack([torch.full((n,), -1.0, dtype=torch.float64), torch.full((n,), 3.0, dtype=torch.float64),
		torch.full((n,), -1.0, dtype=torch.float64)])
	return ptt.DIAOperator(bands, [-1, 0, 1], (n, n))


CALLS = {
	"hutch": lambda op: ptt.hutch(ptt.MatrixFunction(op, "log", deg=20, dtype=torch.float64), batch=8, converge="count",
		count=24, seed=3),
	"kpm_density": lambda op: ptt.kpm_density(op, grid=64, m=32, nv=4, interval="gershgorin", seed=1),
	"kpm_trace": lambda op: ptt.kpm_trace(op, "log", m=32, nv=4, interval="gershgorin", seed=1),
	"spectral_density": lambda op: ptt.spectral_density(op, grid=64, deg=16, nv=4, seed=1),
	"logdet": lambda op: recipes.logdet(op, deg=10, orth=0, converge="count", count=8, batch=4, seed=2),
}
# (estimate, sweep, quadrature) spans a call opens: one sweep and one rule a batch for hutch (24 / 8),
# one sweep for each density; the SLQ density's rule and its bounds, grid and broadening are two
# rules; logdet is a recipe around hutch, so its estimates nest.
COUNTS = {
	"hutch": (1, 3, 3),
	"kpm_density": (1, 1, 1),
	"kpm_trace": (1, 1, 1),
	"spectral_density": (1, 1, 2),
	"logdet": (2, 2, 2),
}


def _traced(fn):
	"""``fn()``'s value and the program's spans it opened, ``(name, start_ns, end_ns)`` by start."""
	with profile(activities=[ProfilerActivity.CPU]) as prof:
		out = fn()
	events = prof.profiler.kineto_results.events()
	spans = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns()) for e in events if e.name().startswith("primate.")]
	return out, sorted(spans, key=lambda s: (s[1], -s[2]))


def _inside(inner, outer) -> bool:
	return outer[1] <= inner[1] and inner[2] <= outer[2]


@pytest.mark.parametrize("call", sorted(CALLS))
def test_a_call_opens_its_spans_nested(call):
	_, spans = _traced(lambda: CALLS[call](_path()))
	by = {k: [s for s in spans if s[0] == f"primate.{k}"] for k in ("estimate", "sweep", "quadrature")}
	assert tuple(len(by[k]) for k in ("estimate", "sweep", "quadrature")) == COUNTS[call]
	assert len(spans) == sum(COUNTS[call])
	outer = by["estimate"][0]
	assert all(_inside(s, outer) for s in spans)  # the first estimate encloses the call
	for sweep in by["sweep"]:
		assert all(q[2] <= sweep[1] or sweep[2] <= q[1] for q in by["quadrature"])  # never overlap
	# spans on one thread nest: any two are disjoint or one holds the other
	for i, a in enumerate(spans):
		for b in spans[i + 1:]:
			assert a[2] <= b[1] or _inside(b, a)


def test_two_pass_apply_opens_two_sweeps_and_one_rule():
	op = _path()
	F = ptt.MatrixFunction(op, "log", deg=12, two_pass=True, dtype=torch.float64)
	V = torch.from_numpy(np.random.default_rng(0).normal(size=(N, 3)))
	_, spans = _traced(lambda: F @ V)
	assert [s[0] for s in spans] == ["primate.sweep", "primate.quadrature", "primate.sweep"]


def test_without_a_profiler_no_span_is_recorded_and_no_number_moves(monkeypatch):
	op = _path()
	traced = {call: _traced(lambda c=call: CALLS[c](op))[0] for call in sorted(CALLS)}

	def refuse(name):
		raise AssertionError(f"record_function({name!r}) entered with no profiler running")

	monkeypatch.setattr(torch.profiler, "record_function", refuse)
	assert not torch.autograd._profiler_enabled()
	with annotate("primate.test"):
		pass
	for call in sorted(CALLS):
		got, want = CALLS[call](op), traced[call]
		if isinstance(want, tuple):
			assert all(np.array_equal(g, w) for g, w in zip(got, want)), call
		else:
			assert np.array_equal(np.asarray(got), np.asarray(want)), call
