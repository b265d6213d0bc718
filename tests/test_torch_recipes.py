"""The port's recipes against the JAX package's, on the same numpy inputs (float64).

One counterpart for each test of ``tests/test_recipes.py`` that runs on one device, plus
``DeflatedOperator(fill=)``. The two packages do not share random streams, so parity goes
through the same probes: a numpy host sampler ``pdf(size=...)`` built twice from one seed
for every ``hutch``-based recipe, the same blocks through a ``(generator, shape, dtype)``
callable for ``diag``, and JAX's probe block handed to ``trace_bounds`` through
``recipes._bounds_probes``. Where a recipe estimates a spectral interval by its own
Rayleigh-Ritz sweep, the port is given the interval JAX used. Tolerances: 1e-10 relative
on the same probes, 1e-8 for eigenpair-based recipes (held to JAX's answer and to dense
``eigh``), exact for integers."""

import numpy as np
import pytest
import scipy.linalg
import scipy.sparse as sps
import torch

import jax.numpy as jnp

import primate_tpu as pt
from primate_tpu import recipes as jr
from primate_tpu.random import as_key, sample_isotropic
from primate_tpu_torch import recipes as tr
import primate_tpu_torch as ptt

torch.set_num_threads(1)
RTOL = 1e-10


def _sampler(seed):
	rng = np.random.default_rng(seed)
	return lambda size: rng.choice([-1.0, 1.0], size=size)


def _key_sampler(seed):
	"""The same stream as :func:`_sampler`, as the port's ``(generator, shape, dtype)`` callable."""
	rng = np.random.default_rng(seed)
	return lambda gen, shape, dtype: torch.from_numpy(rng.choice([-1.0, 1.0], size=shape)).to(dtype)


def _spd(n=64, seed=0, lo=0.5, hi=2.0):
	ew = np.random.default_rng(seed).uniform(lo, hi, n)
	return np.asarray(pt.symmetric(n, pd=True, ew=ew, seed=seed), np.float64), ew


def _t(A):
	return torch.from_numpy(np.array(A))


def _close(got, want, rtol=RTOL, atol=0.0):
	np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def _both(name, A, seed, *args, **kw):
	"""``recipes.<name>`` of both packages on one probe stream: (port, JAX)."""
	got = getattr(tr, name)(_t(A), *args, pdf=_sampler(seed), **kw)
	want = getattr(jr, name)(jnp.asarray(A), *args, pdf=_sampler(seed), **kw)
	return got, want


def _jax_block(seed, n, nv):
	return np.asarray(sample_isotropic(as_key(seed), (n, nv), pdf="rademacher", dtype=np.float64))


def _inject_block(monkeypatch, V):
	monkeypatch.setattr(tr, "_bounds_probes", lambda op, nv, pdf, seed: torch.tensor(V, device=op.device))


# --- the SLQ compositions -------------------------------------------------------------------


def test_logdet():
	A, ew = _spd()
	got, want = _both("logdet", A, 1, deg=40, orth=-1, converge="count", count=64)
	assert isinstance(got, float)
	_close(got, want)
	assert abs(got - np.log(ew).sum()) / abs(np.log(ew).sum()) < 0.15


def test_trace_inv():
	A, ew = _spd()
	got, want = _both("trace_inv", A, 2, deg=40, orth=-1, converge="count", count=64)
	_close(got, want)
	assert abs(got - (1 / ew).sum()) / (1 / ew).sum() < 0.1


def test_heat_kernel_and_estrada():
	A, ew = _spd()
	got, want = _both("heat_kernel_trace", A, 3, t=0.5, deg=40, orth=-1, converge="count", count=64)
	_close(got, want)
	assert abs(got - np.exp(-0.5 * ew).sum()) / np.exp(-0.5 * ew).sum() < 0.1
	got, want = _both("estrada_index", A, 4, deg=40, orth=-1, converge="count", count=64)
	_close(got, want)
	assert abs(got - np.exp(ew).sum()) / np.exp(ew).sum() < 0.1
	# An array of times: one sweep per batch for the whole curve.
	got, want = _both("heat_kernel_trace", A, 5, t=np.array([0.25, 1.0]), deg=20, converge="count", count=32)
	assert isinstance(got, np.ndarray) and got.shape == (2,)
	_close(got, want)
	got, want = _both("estrada_index", A, 6, t=np.array([0.5, 1.0]), deg=20, converge="count", count=32)
	_close(got, want)


def test_numrank_and_eigencount():
	n = 60
	ew = np.r_[np.zeros(20), np.random.default_rng(5).uniform(0.5, 1.0, n - 20)]
	A = np.asarray(pt.symmetric(n, ew=ew, seed=5), np.float64)
	r, jrank = _both("numrank", A, 6, threshold=1e-2, deg=40, orth=-1, converge="count", count=128)
	assert isinstance(r, int) and r == jrank and abs(r - (n - 20)) <= 3
	c, jc = _both("eigencount", A, 7, interval=(0.4, 1.01), deg=40, orth=-1, converge="count", count=128)
	assert isinstance(c, int) and c == jc and abs(c - (n - 20)) <= 3


def test_schatten_psd_and_gram():
	A, ew = _spd(n=48, seed=8)
	got, want = _both("schatten", A, 9, p=2.0, deg=40, orth=-1, converge="count", count=64)
	_close(got, want)
	assert abs(got - (ew**2).sum() ** 0.5) / (ew**2).sum() ** 0.5 < 0.1
	got, want = _both("schatten", A, 10, p=np.array([0.5, 1.0, 2.0]), deg=20, converge="count", count=32)
	assert got.shape == (3,)
	_close(got, want)
	# Rectangular data through the Gram operator: Schatten-2 is the Frobenius norm.
	X = np.random.default_rng(10).normal(size=(40, 24))
	got, want = _both("schatten", X, 11, p=2.0, deg=24, orth=-1, gram=True, converge="count", count=128)
	_close(got, want)
	assert abs(got - np.linalg.norm(X, "fro")) / np.linalg.norm(X, "fro") < 0.1
	got = tr.schatten(_t(X), p=np.array([1.0, 2.0]), deg=24, orth=-1, gram=True, converge="count", count=128, pdf=_sampler(11))
	_close(got[1], want)  # one sweep for both norms, on the same probes


def test_heat_kernel_signature_shape():
	n = 40
	L = sps.diags([-np.ones(n - 1), 2.0 * np.ones(n), -np.ones(n - 1)], [-1, 0, 1]).toarray()
	kw = dict(deg=20, orth=5, converge="count", count=40)
	hks = tr.heat_kernel_signature(_t(L), [0.1, 1.0], pdf=_key_sampler(12), **kw)
	want = jr.heat_kernel_signature(jnp.asarray(L), [0.1, 1.0], pdf=_sampler(12), **kw)
	assert isinstance(hks, np.ndarray) and hks.shape == (2, n)
	_close(hks, want)
	true = np.stack([np.diag(scipy.linalg.expm(-t * L)) for t in (0.1, 1.0)])
	assert np.abs(hks - true).mean() < 0.25


def test_heat_kernel_signature_full_result():
	A = np.asarray(pt.symmetric(20, pd=True, seed=7), np.float64)
	kw = dict(converge="count", count=16, full=True)
	(hks, result) = tr.heat_kernel_signature(_t(A), [0.5, 1.0], pdf=_key_sampler(8), **kw)
	(jhks, jresult) = jr.heat_kernel_signature(jnp.asarray(A), [0.5, 1.0], pdf=_sampler(8), **kw)
	assert hks.shape == (2, 20) and result.nit == jresult.nit > 0
	_close(hks, jhks)


def test_effective_dim_curve_shares_sweeps():
	rng = np.random.default_rng(0)
	n = 150
	ew = np.sort(rng.uniform(0.01, 5.0, n))
	A = np.asarray(pt.symmetric(n, pd=True, ew=ew, seed=1), np.float64)
	lams = np.array([0.01, 0.1, 1.0, 10.0])
	est, want = _both("effective_dim", A, 2, lam=lams, deg=40, orth=-1, converge="count", count=64)
	assert est.shape == (4,)
	_close(est, want)
	true = np.array([(ew / (ew + lam)).sum() for lam in lams])
	assert np.all(np.abs(est - true) / true < 0.03) and np.all(np.diff(est) < 0)
	e1, je1 = _both("effective_dim", A, 3, lam=0.5, deg=40, orth=-1, converge="count", count=64)
	_close(e1, je1)


def test_recipe_closures_have_stable_identity():
	m = tr._memo_fun
	assert m("effdim", 0.5) is m("effdim", 0.5)
	assert m("window", 0.0, 1.0, 0.02) is m("window", 0.0, 1.0, 0.02)
	assert m("abspow", 2.0) is m("abspow", 2.0)
	assert m("logabs") is m("logabs")
	assert m("effdim", 0.5) is not m("effdim", 0.6)
	assert m("grampow_fam", 1.0, 2.0) is m("grampow_fam", 1.0, 2.0)
	# Each closure computes what JAX's does, on the same nodes.
	x = np.linspace(-2.0, 3.0, 41)
	for key in (("effdim", 0.5), ("window", 0.0, 1.0, 0.02), ("abspow", 1.5), ("logabs",), ("grampow", 3.0),
		("effdim_fam", 0.5, 2.0), ("abspow_fam", 0.5, 2.0), ("grampow_fam", 1.0, 2.0)):
		_close(m(*key)(torch.from_numpy(x)), jr._memo_fun(*key)(jnp.asarray(x)), 1e-13, 1e-300)
	# A shifted family is memoised on (f, shifts) too.
	f = ptt.special.param_callable("log")
	assert tr._shift_family(f, (0.0, 1.0)) is tr._shift_family(f, (0.0, 1.0))


# --- shifted traces ------------------------------------------------------------------------


def test_shifted_trace_logdet_curve():
	rng = np.random.default_rng(31)
	ew = rng.uniform(0.5, 2.0, 64)
	A = np.asarray(pt.symmetric(64, pd=True, ew=ew, seed=37), np.float64)
	ts = np.asarray([0.0, 0.5, 1.0, 2.0])
	curve, want = _both("shifted_trace", A, 41, "log", shifts=ts, deg=24, orth=-1, converge="count", count=64)
	assert curve.shape == (4,)
	_close(curve, want)
	true = np.asarray([np.log(ew + t).sum() for t in ts])
	assert np.max(np.abs(curve - true)) <= 0.05 * np.abs(true).max() and np.all(np.diff(curve) > 0)


def test_shifted_trace_shares_probes():
	"""The port's own seeded stream: overlapping shifts of two grids agree exactly."""
	A = _t(np.asarray(pt.symmetric(48, pd=True, seed=43), np.float64))
	a = tr.shifted_trace(A, "log", shifts=[1.0, 2.0], deg=16, converge="count", count=64, seed=47)
	b = tr.shifted_trace(A, "log", shifts=[1.0, 3.0], deg=16, converge="count", count=64, seed=47)
	assert float(a[0]) == float(b[0])
	got, want = _both("shifted_trace", A.numpy(), 48, "log", shifts=[1.0, 3.0], deg=16, converge="count", count=32)
	_close(got, want)


def test_shifted_trace_unhashable_callable():
	class LogLike:
		def __eq__(self, other):
			return self is other

		__hash__ = None

		def __call__(self, x):
			return torch.log(x)

	class JaxLogLike(LogLike):
		__hash__ = None

		def __call__(self, x):
			return jnp.log(x)

	ew = np.random.default_rng(5).uniform(0.5, 2.0, 48)
	A = np.asarray(pt.symmetric(48, pd=True, ew=ew, seed=53), np.float64)
	kw = dict(shifts=[0.0, 1.0], deg=20, orth=-1, converge="count", count=64)
	curve = tr.shifted_trace(_t(A), LogLike(), pdf=_sampler(5), **kw)
	want = jr.shifted_trace(jnp.asarray(A), JaxLogLike(), pdf=_sampler(5), **kw)
	_close(curve, want)
	true = np.asarray([np.log(ew).sum(), np.log(ew + 1.0).sum()])
	assert np.max(np.abs(curve - true)) <= 0.05 * np.abs(true).max()


# --- the brackets ----------------------------------------------------------------------------


def _bounds_both(monkeypatch, A, fun, seed, nv, **kw):
	"""trace_bounds of both packages on JAX's probe block and JAX's interval: (port, JAX)."""
	want = jr.trace_bounds(A, fun, nv=nv, seed=seed, full=True, **kw)
	_inject_block(monkeypatch, _jax_block(seed, A.shape[1], nv))
	got = tr.trace_bounds(_t(A) if isinstance(A, np.ndarray) else A, fun, nv=nv, seed=seed, full=True,
		**{**kw, "interval": want["interval"]})
	for key in ("lower", "upper", "mc_stderr"):
		_close(got[key], want[key])
	for name in want["rules"]:
		_close(got["rules"][name], want["rules"][name])
		_close(got["samples"][name], want["samples"][name])
	assert got["kind"] == want["kind"] and got["nv"] == want["nv"]
	return got, want


def test_trace_bounds_brackets_logdet_quadrature(monkeypatch):
	rng = np.random.default_rng(3)
	n, nv = 64, 16
	ew = rng.uniform(0.5, 4.0, n)
	A = np.asarray(pt.symmetric(n, pd=True, ew=ew, seed=4), np.float64)
	_bounds_both(monkeypatch, A, "log", 11, nv, deg=12)
	# The port's own interval (its Rayleigh-Ritz sweep) on the same probes still brackets
	# the probes' exact mean of vᵀ log(A) v.
	res = tr.trace_bounds(_t(A), "log", deg=12, nv=nv, seed=11, full=True)
	lam, U = np.linalg.eigh(A)
	V = _jax_block(11, n, nv)
	sample_mean = float(np.einsum("ij,ij->j", V, (U * np.log(lam)) @ U.T @ V).mean())
	assert res["lower"] - 1e-8 <= sample_mean <= res["upper"] + 1e-8
	assert abs(res["rules"]["gauss"] - np.log(ew).sum()) < 5 * res["mc_stderr"] + 1e-6


def test_trace_bounds_kind_inference_and_custom(monkeypatch):
	rng = np.random.default_rng(5)
	n = 64
	ew = rng.uniform(0.4, 2.0, n)
	A = np.asarray(pt.symmetric(n, pd=True, ew=ew, seed=6), np.float64)
	for fun, kw in (("inv", {}), ("exp", {}), ("sqrt", {}), ("exp", {"fun_kwargs": {"t": -1.0}})):
		got, want = _bounds_both(monkeypatch, A, fun, 1, 16, deg=12, **kw)
		assert got["lower"] <= got["upper"]
	assert got["kind"] == "completely_monotone"
	with pytest.raises(ValueError, match="derivative-sign class"):
		tr.trace_bounds(_t(A), lambda x: x**0.5, deg=8, nv=8, seed=0)
	lo, hi = tr.trace_bounds(_t(A), lambda x: x**0.5, kind="bernstein", deg=10, nv=8, seed=0)
	assert lo <= hi


def test_trace_bounds_gram_path(monkeypatch):
	from primate_tpu.operators.sparse import GramOperator as JaxGram

	rng = np.random.default_rng(0)
	X = rng.normal(size=(90, 64)) + 2 * np.eye(90, 64)
	want = jr.trace_bounds(JaxGram(jnp.asarray(X)), "log", deg=12, nv=16, seed=2, full=True)
	_inject_block(monkeypatch, _jax_block(2, 64, 16))
	got = tr.trace_bounds(ptt.GramOperator(_t(X)), "log", deg=12, nv=16, seed=2, full=True, interval=want["interval"])
	for key in ("lower", "upper", "mc_stderr"):
		_close(got[key], want[key])
	lam, Q = np.linalg.eigh(X.T @ X)
	V = _jax_block(2, 64, 16)
	sm = float(np.einsum("ij,ij->j", V, (Q * np.log(lam)) @ Q.T @ V).mean())
	assert got["lower"] - 1e-8 <= sm <= got["upper"] + 1e-8


def test_trace_bounds_log_tiny_lambda_min_not_garbage(monkeypatch):
	ew = np.concatenate([[0.01], np.linspace(1.0, 10.0, 63)])
	A = np.asarray(pt.symmetric(64, pd=True, ew=ew, seed=9), np.float64)
	_bounds_both(monkeypatch, A, "log", 10, 16, deg=24)
	# The port's own interval keeps a positive lower end.
	res = tr.trace_bounds(_t(A), "log", deg=24, nv=16, seed=10, full=True)
	lo, hi = res["lower"], res["upper"]
	assert res["interval"][0] > 0 and hi >= lo and hi - lo < 5 and abs(0.5 * (lo + hi) - np.sum(np.log(ew))) < 10


def test_trace_bounds_inv_wide_spectrum_not_inverted(monkeypatch):
	rng = np.random.default_rng(0)
	ew = np.concatenate([[1e-3, 2e-3], rng.uniform(0.1, 1.0, 62)])
	A = np.asarray(pt.symmetric(64, pd=True, ew=ew, seed=1), np.float64)
	_bounds_both(monkeypatch, A, "inv", 2, 16, deg=24)
	res = tr.trace_bounds(_t(A), "inv", deg=24, nv=16, seed=2, full=True)
	assert np.isfinite(res["lower"]) and np.isfinite(res["upper"]) and res["lower"] <= res["upper"] + 1e-9
	lam, U = np.linalg.eigh(A)
	V = _jax_block(2, 64, 16)
	sm = float(np.einsum("ij,ij->j", V, (U / lam) @ U.T @ V).mean())
	assert res["lower"] - 1e-6 <= sm <= res["upper"] + 1e-6


def test_trace_bounds_float32_converged_bracket_collapses():
	"""At full degree the four rules agree to rounding; in float32 that rounding crosses JAX's
	float64 bound (1e-9 relative) on some probe sets, and the port collapses the bracket."""
	rng = np.random.default_rng(0)
	n = 64
	Q, _ = np.linalg.qr(rng.normal(size=(n, n)))
	A = (Q * rng.uniform(1e3, 1e4, n)) @ Q.T
	for seed in range(8):
		kw = dict(deg=n, nv=16, seed=seed, full=True, interval=(500.0, 2e4))
		res = tr.trace_bounds(torch.from_numpy(A.astype(np.float32)), "log", **kw)
		res64 = tr.trace_bounds(torch.from_numpy(A), "log", **kw)
		assert res["lower"] <= res["upper"]
		_close(res["lower"], res64["lower"], 1e-5)


def test_suggest_degree_converges_and_is_monotone(monkeypatch):
	rng = np.random.default_rng(21)
	n = 64
	ew = rng.uniform(0.05, 3.0, n)
	A = np.asarray(pt.symmetric(n, ew=ew, pd=True, seed=22), np.float64)
	kw = dict(rtol=1e-3, nv=16, deg0=6, seed=3, full=True, interval=(0.025, 3.1))
	jdeg, jhist = jr.suggest_degree(A, "log", **kw)
	_inject_block(monkeypatch, _jax_block(3, n, 16))
	deg, hist = tr.suggest_degree(_t(A), "log", **kw)
	assert deg == jdeg and [h["deg"] for h in hist] == [h["deg"] for h in jhist]
	for h, jh in zip(hist, jhist):
		_close([h["lower"], h["upper"]], [jh["lower"], jh["upper"]])
	gaps = [h["gap"] for h in hist]
	assert len(gaps) > 1 and all(g1 >= g2 for g1, g2 in zip(gaps, gaps[1:]))
	lo, hi = hist[-1]["lower"], hist[-1]["upper"]
	assert hi - lo <= 1e-3 * abs(0.5 * (lo + hi)) * 1.0001


def test_suggest_degree_caps(monkeypatch):
	A = np.asarray(pt.symmetric(64, pd=True, seed=30), np.float64)
	lam = np.linalg.eigvalsh(A)
	interval = (0.5 * lam[0], 1.05 * lam[-1])
	_inject_block(monkeypatch, _jax_block(0, 64, 16))
	kw = dict(rtol=0.0, atol=0.0, deg0=6, max_deg=24, nv=16, seed=0, full=True, interval=interval)
	deg, hist = tr.suggest_degree(_t(A), "log", **kw)
	jdeg, jhist = jr.suggest_degree(A, "log", **kw)
	assert deg == jdeg == 24 and hist[-1]["deg"] == deg and [h["deg"] for h in hist] == [h["deg"] for h in jhist]
	# exp converges spectrally fast: a small degree suffices.
	d2 = tr.suggest_degree(_t(A), "exp", rtol=1e-6, deg0=6, nv=16, seed=0, interval=interval)
	assert d2 == jr.suggest_degree(A, "exp", rtol=1e-6, deg0=6, nv=16, seed=0, interval=interval) <= 24


def test_suggest_probes_bound():
	assert tr.suggest_probes(eps=0.1, eta=0.05, method="bound") == jr.suggest_probes(eps=0.1, eta=0.05, method="bound")
	nv2, info = tr.suggest_probes(eps=0.5, eta=0.5, full=True)
	assert (nv2, info) == jr.suggest_probes(eps=0.5, eta=0.5, full=True) and info["method"] == "bound"


def _probes_both(A, seed, **kw):
	got = tr.suggest_probes(_t(A), pdf=_sampler(seed), full=True, **kw)
	want = jr.suggest_probes(jnp.asarray(A), pdf=_sampler(seed), full=True, **kw)
	assert got[0] == want[0]
	for key in ("estimate", "variance", "variance_bound", "z"):
		_close(got[1][key], want[1][key])
	return got


def test_suggest_probes_clt_sizes_to_target():
	rng = np.random.default_rng(5)
	ew = rng.uniform(0.5, 2.0, 64)
	A = np.asarray(pt.symmetric(64, pd=True, ew=ew, seed=7), np.float64)
	nv, info = _probes_both(A, 11, eps=0.02, eta=0.05, pilot=64)
	assert info["method"] == "clt" and nv >= 64
	_, res = ptt.hutch(_t(A), converge="count", count=nv, batch=min(nv, 256), seed=13, full=True)
	est = ptt.ConfidenceEstimator(confidence=0.95, dtype=torch.float64, device="cpu")
	est.state = res.estimator.state
	assert est.margin_of_error <= 3 * 0.02 * ew.sum()
	assert abs(res.estimate - ew.sum()) <= 3 * 0.02 * ew.sum()


def test_suggest_probes_chi2_bound_is_conservative():
	rng = np.random.default_rng(29)
	ew = rng.uniform(0.5, 2.0, 64)
	A = np.asarray(pt.symmetric(64, pd=True, ew=ew, seed=31), np.float64)
	nv_c, info_c = _probes_both(A, 37, eps=0.02, pilot=16)
	nv_p, info_p = _probes_both(A, 37, eps=0.02, pilot=16, conservative=False)
	assert info_c["variance_bound"] > info_c["variance"] and info_p["variance_bound"] == info_p["variance"]
	assert nv_c >= nv_p
	_, info_big = _probes_both(A, 37, eps=0.02, pilot=256)
	assert info_big["variance_bound"] / info_big["variance"] < info_c["variance_bound"] / info_c["variance"]


def test_suggest_probes_matrix_function():
	ew = np.random.default_rng(17).uniform(0.5, 2.0, 48)
	A = np.asarray(pt.symmetric(48, pd=True, ew=ew, seed=19), np.float64)
	nv, _ = _probes_both(A, 23, fun="log", eps=0.1, pilot=16, deg=24)
	assert isinstance(nv, int) and nv >= 16


# --- solves and eigenspaces ------------------------------------------------------------------


def test_trace_inv_cg_backend():
	"""Hutchinson over preconditioned CG solves on the same probes: JAX's Nyström
	preconditioner carried across, Jacobi and none, each the probes' exact mean of
	``vᵀA⁻¹v``; and the port's ``"nystrom"`` string is its prebuilt preconditioner of the same seed."""
	from primate_tpu.solvers import nystrom_precond

	n = 200
	ew = np.concatenate([np.geomspace(100, 5, 8), np.random.default_rng(0).uniform(0.5, 2.0, n - 8)])
	A = np.asarray(pt.symmetric(n, pd=True, ew=ew, seed=1), np.float64)
	gt = float(np.sum(1.0 / ew))
	draw = _sampler(2)
	V = np.concatenate([draw(size=(n, 32)), draw(size=(n, 32))], axis=1)  # two batches of 32
	exact = float(np.mean(np.einsum("ij,ij->j", V, np.linalg.solve(A, V))))
	P = nystrom_precond(A, rank=16, seed=5)
	kw = dict(method="cg", rtol=1e-13, converge="count", count=64)
	want = jr.trace_inv(A, precond=P, pdf=_sampler(2), **kw)
	for pre in (ptt.nystrom_from_numpy(np.asarray(P.U), np.asarray(P.coef), device="cpu"), "jacobi", None):
		got = tr.trace_inv(_t(A), precond=pre, pdf=_sampler(2), **kw)
		_close(got, want, 1e-9)
		_close(got, exact, 1e-9)
	assert abs(got - gt) / gt < 0.1
	# Same probes, both converged: CG and a high-degree SLQ agree.
	slq = tr.trace_inv(_t(A), deg=60, orth=-1, pdf=_sampler(2), converge="count", count=64)
	assert np.isclose(got, slq, rtol=1e-6)
	op = ptt.DenseOperator(_t(A))
	own = tr.trace_inv(op, method="cg", precond="nystrom", seed=4, converge="count", count=32)
	assert own == tr.trace_inv(op, method="cg", precond=ptt.nystrom_precond(op, seed=4), seed=4, converge="count", count=32)


def test_tikhonov_solve():
	rng = np.random.default_rng(2)
	ew = rng.uniform(0.0, 2.0, 48)
	A = np.asarray(pt.symmetric(48, ew=ew, seed=3), np.float64)
	for B in (rng.normal(size=48), rng.normal(size=(48, 3))):
		X = tr.tikhonov(_t(A), _t(B), lam=0.5, rtol=1e-13)
		assert isinstance(X, torch.Tensor) and X.shape == B.shape
		_close(X, jr.tikhonov(A, jnp.asarray(B), lam=0.5, rtol=1e-13), 1e-10)
		_close(X, np.linalg.solve(A + 0.5 * np.eye(48), B), 1e-10, 1e-12)
	with pytest.raises(ValueError):
		tr.tikhonov(_t(A), _t(B), lam=0.0)


def _normalized_adjacency(n=60, seed=19):
	rng = np.random.default_rng(seed)
	W = sps.random(n, n, density=0.1, random_state=7, data_rvs=lambda s: rng.uniform(0.5, 1.0, s))
	W = W + W.T
	W.setdiag(0)
	W.eliminate_zeros()
	d = np.asarray(W.sum(axis=1)).ravel()
	d[d == 0] = 1.0
	Dinv = sps.diags(1.0 / np.sqrt(d))
	return (Dinv @ W @ Dinv).tocsr()


def test_pagerank_resolvent():
	A = _normalized_adjacency()
	n, alpha = A.shape[0], 0.85
	op = ptt.CSROperator.from_scipy(A, device="cpu")
	x = tr.pagerank(op, alpha=alpha, rtol=1e-13)
	assert x.device.type == "cpu" and x.shape == (n,)
	dense = np.linalg.solve(np.eye(n) - alpha * A.toarray(), np.full(n, 1.0 / n)) * (1 - alpha)
	_close(x, dense, 1e-10)
	_close(x, jr.pagerank(A, alpha=alpha, rtol=1e-13), 1e-10)
	Vs = np.eye(n, 3)
	Xb = tr.pagerank(op, alpha=alpha, v=_t(Vs), rtol=1e-13)
	_close(Xb, np.linalg.solve(np.eye(n) - alpha * A.toarray(), Vs) * (1 - alpha), 1e-10, 1e-14)
	Xf, it, res = tr.pagerank(op, alpha=alpha, v=_t(Vs), rtol=1e-13, full=True)
	assert torch.equal(Xf, Xb) and it > 0


def test_topk_projector():
	rng = np.random.default_rng(11)
	ew = np.sort(rng.uniform(0.1, 1.0, 80))
	ew[-3:] = [5.0, 6.0, 7.0]
	A = np.asarray(pt.symmetric(80, ew=ew, seed=13), np.float64)
	P, vals, V = tr.topk(_t(A), k=3, which="LM", return_eigenvectors=True, seed=17, tol=1e-14)
	_, jvals, _ = jr.topk(A, k=3, which="LM", return_eigenvectors=True, seed=17)
	_close(np.sort(vals.numpy()), np.sort(np.asarray(jvals)), 1e-8)
	_close(np.sort(vals.numpy()), [5.0, 6.0, 7.0], 1e-8)
	w, U = np.linalg.eigh(A)
	Pd = U[:, -3:] @ U[:, -3:].T
	x = _t(rng.standard_normal(80))
	_close(P @ x, Pd @ x.numpy(), 0.0, 1e-8)
	_close(P @ (P @ x), P @ x, 0.0, 1e-12)
	assert abs(float(torch.trace(P @ torch.eye(80, dtype=torch.float64))) - 3.0) < 1e-12


def test_topk_projector_float32():
	"""The projector's GEMMs in float32 (full float32 on the card, TF32 off)."""
	rng = np.random.default_rng(12)
	ew = np.sort(rng.uniform(0.1, 1.0, 80))
	ew[-3:] = [5.0, 6.0, 7.0]
	A = np.asarray(pt.symmetric(80, ew=ew, seed=14), np.float64)
	P, vals, V = tr.topk(torch.from_numpy(A.astype(np.float32)), k=3, which="LA", return_eigenvectors=True, seed=1)
	assert V.dtype == torch.float32
	U = np.linalg.eigh(A)[1][:, -3:]
	x = torch.from_numpy(rng.standard_normal(80).astype(np.float32))
	_close(P @ x, U @ (U.T @ x.double().numpy()), 0.0, 1e-4)


def test_condition_number():
	rng = np.random.default_rng(3)
	ew = np.sort(rng.uniform(0.05, 8.0, 120))
	A = np.asarray(pt.symmetric(120, pd=True, ew=ew, seed=4), np.float64)
	k = tr.condition_number(_t(A), seed=5, method="trlan")
	_close(k, jr.condition_number(A, seed=5, method="trlan"), 1e-8)
	_close(k, ew[-1] / ew[0], 1e-8)
	B = np.asarray(pt.symmetric(60, ew=np.linspace(-1, 2, 60), seed=6), np.float64)
	with pytest.raises(ValueError):
		tr.condition_number(_t(B), seed=7)


def test_slogdet_indefinite():
	rng = np.random.default_rng(0)
	for n_neg, seed in ((7, 1), (8, 3)):
		ew = np.sort(np.concatenate([rng.uniform(-3, -0.5, n_neg), rng.uniform(0.5, 3, 100 - n_neg)]))
		A = np.asarray(pt.symmetric(100, ew=ew, seed=seed), np.float64)
		kw = dict(deg=40, orth=-1, converge="count", count=256, full=True)
		(s, ld), res = tr.slogdet(_t(A), pdf=_sampler(seed + 1), seed=seed, **kw)
		(js, jld), jres = jr.slogdet(jnp.asarray(A), pdf=_sampler(seed + 1), seed=seed, **kw)
		s_t, ld_t = np.linalg.slogdet(A)
		assert s == js == s_t and res.info["n_negative"] == jres.info["n_negative"] == n_neg
		_close(ld, jld)
		assert abs(ld - ld_t) / abs(ld_t) < 0.02


def test_slogdet_spd_skips_count_and_full_result():
	ew = np.random.default_rng(5).uniform(0.5, 2.0, 100)
	A = np.asarray(pt.symmetric(100, pd=True, ew=ew, seed=5), np.float64)
	kw = dict(deg=40, orth=-1, converge="count", count=128, seed=6, full=True)
	(s, ld), result = tr.slogdet(_t(A), pdf=_sampler(6), **kw)
	(js, jld), _ = jr.slogdet(jnp.asarray(A), pdf=_sampler(6), **kw)
	assert s == js == 1.0 and result.info["n_negative"] == 0
	_close(ld, jld)
	assert abs(ld - np.sum(np.log(ew))) / abs(np.sum(np.log(ew))) < 0.05


def test_slogdet_spd_tiny_minimum_keeps_positive_sign():
	ew = np.concatenate([[1e-4, 2e-4], np.random.default_rng(7).uniform(10, 100, 98)])
	A = np.asarray(pt.symmetric(100, pd=True, ew=ew, seed=8), np.float64)
	kw = dict(deg=40, orth=-1, converge="count", count=64, seed=9, full=True)
	(s, ld), res = tr.slogdet(_t(A), pdf=_sampler(9), **kw)
	(js, jld), jres = jr.slogdet(jnp.asarray(A), pdf=_sampler(9), **kw)
	assert s == js == 1.0 and res.info["n_negative"] == jres.info["n_negative"] == 0
	_close(ld, jld)


# --- forms and weighted traces ---------------------------------------------------------------


def test_bilinear_form_entries_match_dense():
	rng = np.random.default_rng(0)
	n = 48
	A = np.asarray(pt.symmetric(n, ew=rng.uniform(0.5, 2.0, n), pd=True, seed=1), np.float64)
	lam, Q = np.linalg.eigh(A)
	for fun, f in [("exp", np.exp), ("log", np.log), ("inv", lambda x: 1 / x)]:
		U, V = rng.normal(size=(n, 5)), rng.normal(size=(n, 5))
		got = tr.bilinear_form(_t(A), _t(U), _t(V), fun=fun, deg=n, orth=n)
		assert isinstance(got, np.ndarray) and got.shape == (5,)
		_close(got, jr.bilinear_form(A, U, V, fun=fun, deg=n, orth=n), 1e-8, 1e-10)
		_close(got, np.einsum("ij,ij->j", U, (Q * f(lam)) @ Q.T @ V), 0.0, 1e-8)


def test_bilinear_form_single_vector_and_quadratic():
	rng = np.random.default_rng(3)
	n = 40
	A = np.asarray(pt.symmetric(n, pd=True, seed=5), np.float64)
	lam, Q = np.linalg.eigh(A)
	expA = (Q * np.exp(lam)) @ Q.T
	ei, ej = np.eye(n)[:, 7], np.eye(n)[:, 19]
	got = tr.bilinear_form(_t(A), _t(ei), _t(ej), fun="exp", deg=n, orth=n)
	assert np.shape(got) == ()
	_close(got, expA[7, 19], 0.0, 1e-8)
	_close(got, jr.bilinear_form(A, ei, ej, fun="exp", deg=n, orth=n), 0.0, 1e-10)
	u = rng.normal(size=n)
	gq = tr.bilinear_form(_t(A), _t(u), fun="exp", deg=n, orth=n)
	_close(gq, u @ expA @ u, 1e-8)
	_close(tr.bilinear_form(_t(A), _t(u), _t(u), fun="exp", deg=n, orth=n), gq, 1e-6)


def test_bilinear_form_complex_entry():
	H = np.asarray(pt.random.hermitian(30, ew=np.linspace(0.1, 3.0, 30), seed=5))
	w, V = np.linalg.eigh(H)
	F = (V * np.exp(w)) @ V.conj().T
	u = np.zeros(30, complex)
	u[2] = 1
	v = np.zeros(30, complex)
	v[7] = 1
	got = tr.bilinear_form(_t(H), _t(u), _t(v), fun="exp", deg=30, orth=-1)
	assert abs(got - F[2, 7]) / abs(F[2, 7]) < 1e-8
	want = jr.bilinear_form(jnp.asarray(H), jnp.asarray(u), jnp.asarray(v), fun="exp", deg=30, orth=-1)
	assert abs(got - want) / abs(want) < 1e-8


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_weighted_trace_plain_and_matrix_function(dtype):
	"""JAX's answer in float64; in float32 (the bra-ket sum and B's GEMM in full float32)
	the port's float64 answer on the same probes."""
	rng = np.random.default_rng(7)
	n = 64
	A = np.asarray(pt.symmetric(n, pd=True, ew=rng.uniform(0.5, 1.5, n), seed=11), np.float64)
	B = rng.normal(size=(n, n))
	B = (B + B.T) / 2
	lam, Q = np.linalg.eigh(A)
	invA = (Q / lam) @ Q.T
	kw = dict(converge="count", count=256, batch=64)
	for fun, fkw, true, seed in ((None, {}, A, 0), ("inv", dict(deg=32, orth=8), invA, 1)):
		got = tr.weighted_trace(_t(A).to(dtype), _t(B).to(dtype), fun=fun, pdf=_sampler(seed), **fkw, **kw)
		if dtype == torch.float64:
			_close(got, jr.weighted_trace(A, B, fun=fun, pdf=_sampler(seed), **fkw, **kw))
		else:
			_close(got, tr.weighted_trace(_t(A), _t(B), fun=fun, pdf=_sampler(seed), **fkw, **kw), 1e-5)
		assert abs(got - np.trace(true @ B)) <= 0.1 * np.abs(np.linalg.eigvalsh(true @ B)).sum() + 0.5


def test_weighted_trace_diagonal_weights():
	rng = np.random.default_rng(9)
	n = 50
	A = np.asarray(pt.symmetric(n, pd=True, seed=13), np.float64)
	lam, Q = np.linalg.eigh(A)
	expA = (Q * np.exp(lam)) @ Q.T
	w = rng.uniform(0.0, 2.0, n)
	kw = dict(fun="exp", deg=n, orth=n, converge="count", count=256, batch=64)
	got = tr.weighted_trace(_t(A), w, pdf=_sampler(2), **kw)
	_close(got, jr.weighted_trace(A, w, pdf=_sampler(2), **kw))
	true = float(np.sum(w * np.diag(expA)))
	assert abs(got - true) / abs(true) < 0.1
	# A weight tensor keeps the operator's device.
	_close(tr.weighted_trace(_t(A), _t(w), pdf=_sampler(2), **kw), got, 1e-14)


def test_weighted_trace_complex_hermitian():
	rng = np.random.default_rng(0)
	n = 40
	H = np.asarray(pt.random.hermitian(n, ew=np.linspace(0.5, 2.0, n), seed=1))
	B = np.asarray(pt.random.hermitian(n, ew=rng.uniform(-1, 1, n), seed=2))
	true = float(np.real(np.trace(B @ H)))
	got = tr.weighted_trace(_t(H), _t(B), fun=None, converge="count", count=1024, pdf=_sampler(3))
	_close(got, jr.weighted_trace(jnp.asarray(H), jnp.asarray(B), fun=None, converge="count", count=1024, pdf=_sampler(3)))
	assert abs(got - true) / abs(true) < 0.2


# --- deflation -------------------------------------------------------------------------------


@pytest.mark.parametrize("complex_", [False, True])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_deflated_operator_fill_matches_jax(dtype, complex_):
	"""``P A P + fill·VVᴴ`` against JAX's ``matmat``; ``fill=0`` is the projection alone."""
	from primate_tpu.operators import DeflatedOperator as JaxDeflated

	rng = np.random.default_rng(40)
	n, k = 50, 4
	if complex_:
		A = np.asarray(pt.random.hermitian(n, ew=rng.uniform(0.5, 2.0, n), seed=41))
		V, _ = np.linalg.qr(rng.normal(size=(n, k)) + 1j * rng.normal(size=(n, k)))
		W = rng.normal(size=(n, 3)) + 1j * rng.normal(size=(n, 3))
		npd = {"float64": np.complex128, "float32": np.complex64}[dtype]
	else:
		A = np.asarray(pt.symmetric(n, ew=rng.uniform(0.5, 2.0, n), seed=41), np.float64)
		V, _ = np.linalg.qr(rng.normal(size=(n, k)))
		W = rng.normal(size=(n, 3))
		npd = np.dtype(dtype).type
	A, V, W = A.astype(npd), V.astype(npd), W.astype(npd)
	tol = 1e-12 if dtype == "float64" else 1e-5
	for fill in (0.0, 1.0, 2.5):
		got = ptt.DeflatedOperator(torch.from_numpy(A), torch.from_numpy(V), fill=fill).matmat(torch.from_numpy(W))
		want = JaxDeflated(jnp.asarray(A), jnp.asarray(V), fill=fill).matmat(jnp.asarray(W))
		scale = np.abs(np.asarray(want)).max()
		_close(got.numpy() / scale, np.asarray(want) / scale, 0.0, tol)
	P = np.eye(n) - V @ V.conj().T
	dense = P @ A @ P + 2.5 * V @ V.conj().T
	_close(got.numpy() / scale, dense @ W / scale, 0.0, 10 * tol)
	plain = ptt.DeflatedOperator(torch.from_numpy(A), torch.from_numpy(V))
	assert plain.fill == 0 and torch.equal(plain.matmat(torch.from_numpy(W)), ptt.DeflatedOperator(
		torch.from_numpy(A), torch.from_numpy(V), fill=0.0).matmat(torch.from_numpy(W)))


@pytest.mark.parametrize("fun", [None, "log"])
def test_deflated_trace_real(fun):
	"""Exact top-8 eigenspace (dense eigh at this size in both packages) plus SLQ on the rest."""
	rng = np.random.default_rng(50)
	ew = np.concatenate([rng.uniform(0.5, 2.0, 32), [20.0, 30.0, 40.0, 50.0]])
	A = np.asarray(pt.symmetric(36, pd=True, ew=ew, seed=51), np.float64)
	kw = dict(fun=fun, k=4, which="LA", converge="count", count=128, seed=52, full=True)
	est, res = tr.deflated_trace(_t(A), pdf=_sampler(53), **kw)
	jest, jres = jr.deflated_trace(jnp.asarray(A), pdf=_sampler(53), **kw)
	_close(est, jest, 1e-8)
	_close(np.sort(res.info["deflated_eigenvalues"]), [20.0, 30.0, 40.0, 50.0], 1e-10)
	true = ew.sum() if fun is None else np.log(ew).sum()
	assert abs(est - true) / abs(true) < 0.05


def test_deflated_trace_complex_hermitian():
	H = np.asarray(pt.random.hermitian(30, ew=np.linspace(0.1, 3.0, 30), seed=5))
	kw = dict(k=4, converge="count", count=256, seed=6)
	est = tr.deflated_trace(_t(H), "log", pdf=_sampler(7), **kw)
	_close(est, jr.deflated_trace(jnp.asarray(H), "log", pdf=_sampler(7), **kw), 1e-8)
	true = np.sum(np.log(np.linspace(0.1, 3.0, 30)))
	assert abs(est - true) / abs(true) < 0.15
