"""``primate_tpu_torch.plotting`` against ``primate_tpu.plotting``: the numpy helpers on the same
samples, and each figure drawn by both packages under matplotlib's Agg backend with the same
curves (1e-12; the orthogonal polynomials run through each package's own recurrence)."""

import sys

import numpy as np
import pytest
import torch

from primate_tpu import plotting as jplot

import primate_tpu_torch as ptt
from primate_tpu_torch import plotting as tplot

torch.set_num_threads(1)


@pytest.fixture
def plt():
	mpl = pytest.importorskip("matplotlib")
	mpl.use("Agg")
	import matplotlib.pyplot as plt

	yield plt
	plt.close("all")


def _samples():
	return 1e6 + np.random.default_rng(0).normal(size=200)


def test_numpy_helpers_match_jax():
	x = _samples()
	for got, want in zip(tplot._running_mean_stderr(x), jplot._running_mean_stderr(x)):
		np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
	avgs, err = tplot._running_mean_stderr(x)
	assert err[0] == 0.0 and abs(err[-1] - np.std(x, ddof=1) / np.sqrt(len(x))) <= 1e-9
	np.testing.assert_array_equal(tplot._sample_values(list(x)), jplot._sample_values(list(x)))


def test_sample_values_of_a_recording_estimator():
	"""The port's estimators keep their samples as a list (``record=True``); without them the
	helper says what to pass."""
	A = torch.from_numpy(np.diag(np.linspace(1.0, 2.0, 30)))
	_, res = ptt.hutch(A, batch=4, converge="count", count=40, seed=1, record=True, full=True)
	vals = tplot._sample_values(res.estimator)
	assert vals.shape == (40,) and np.allclose(vals, res.estimator.values)
	_, res = ptt.hutch(A, batch=4, converge="count", count=8, seed=1, full=True)
	with pytest.raises(ValueError, match="record=True"):
		tplot._sample_values(res.estimator)


def _lines(ax):
	return [(line.get_xdata(), line.get_ydata()) for line in ax.lines]


def _same_lines(a, b):
	la, lb = _lines(a), _lines(b)
	assert len(la) == len(lb) > 0
	for (xa, ya), (xb, yb) in zip(la, lb):
		np.testing.assert_allclose(np.asarray(xa, float), np.asarray(xb, float), rtol=0, atol=1e-12)
		np.testing.assert_allclose(np.asarray(ya, float), np.asarray(yb, float), rtol=1e-12, atol=1e-12)
	assert a.get_title() == b.get_title()


@pytest.mark.parametrize("figure", ["csm", "jacobi", "orth_poly", "fun", "sequence", "error_true", "error_ci"])
def test_figures_draw_the_jax_curves(plt, figure):
	x = _samples()
	rng = np.random.default_rng(1)
	alpha, beta = 2.0 + rng.uniform(size=8), np.r_[0.0, 0.5 + rng.uniform(size=7)]
	calls = {
		"jacobi": lambda m: m.figure_jacobi(deg=5, alpha=0.5, beta=1.0),
		"orth_poly": lambda m: m.figure_orth_poly(alpha, beta, k=5),
		"fun": lambda m: m.figure_fun("smoothstep", bounds=(-0.5, 1.5), a=0.1, b=0.9),
		"sequence": lambda m: m.figure_sequence(x, mu=1e6),
		"error_true": lambda m: m.figure_error(x, mu=1e6, threshold=0.1),
		"error_ci": lambda m: m.figure_error(x, absolute=False),
	}
	if figure == "csm":
		vals = np.sort(rng.uniform(size=20))
		a, b = tplot.figure_csm(torch.from_numpy(vals)), jplot.figure_csm(vals)
	else:
		a, b = calls[figure](tplot), calls[figure](jplot)
	_same_lines(a, b)


def test_confidence_band_matches_jax(plt):
	x = _samples()
	a = tplot.add_confidence_band(tplot.figure_sequence(x), x)
	b = jplot.add_confidence_band(jplot.figure_sequence(x), x)
	pa, pb = a.collections[-1].get_paths()[0].vertices, b.collections[-1].get_paths()[0].vertices
	np.testing.assert_allclose(pa, pb, rtol=1e-12)


def test_figures_say_so_without_matplotlib(monkeypatch):
	"""Where matplotlib does not import (as on the card's machine), a figure raises ImportError
	naming it, and the numpy side still works."""
	monkeypatch.setitem(sys.modules, "matplotlib", None)
	monkeypatch.setitem(sys.modules, "matplotlib.pyplot", None)
	with pytest.raises(ImportError, match="matplotlib"):
		tplot.figure_sequence(_samples())
	dom, P = tplot._orth_poly_curves(np.full(4, 2.0), np.r_[0.0, np.ones(3)])
	assert P.shape == (1500, 4) and np.all(np.isfinite(P))
