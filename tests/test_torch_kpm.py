"""The kernel polynomial method and the spectral densities in the port against the JAX
package: Jackson damping, the Chebyshev coefficients and degree rule, the moment
recurrence, ``kpm_trace`` (families, ``m="auto"``, the gradient of
``differentiable=True``), ``kpm_density``, ``ChebyshevFunction`` (Clenshaw ``matmat``,
moment ``quad``, families) on real and Hermitian operators, ``spectral_density`` and
its cumulative and quantile forms. Counterparts of ``tests/test_kpm.py`` and
``tests/test_density.py`` (the Gram case excepted); float64. The moment sweeps and the
density draw their probes from the JAX package's keys, handed in, so the two packages
agree to rounding; the reference tests' statistical bars are held on the port alone."""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import jax
import jax.numpy as jnp

import primate_tpu as pt
from primate_tpu import density as jax_density
from primate_tpu import kpm as jax_kpm
from primate_tpu.operators.sparse import DIAOperator as JaxDIA
from primate_tpu.random import as_key
from primate_tpu.random import real_dtype as jax_real_dtype
from primate_tpu.random import sample_isotropic as jax_sample

import primate_tpu_torch as ptt
from primate_tpu_torch import ChebyshevFunction, DIAOperator, kpm
from primate_tpu_torch import density as port_density
from primate_tpu_torch.operators.base import DenseOperator

torch.set_num_threads(1)
SEED = 7


def _close(got, want, rtol=1e-10, atol=0.0):
	np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def _spd(n=96, seed=0, lo=0.5, hi=2.0):
	ew = np.random.default_rng(seed).uniform(lo, hi, n)
	return np.array(pt.symmetric(n, pd=True, ew=ew, seed=seed)), ew


def _path(n=256):
	return sps.diags([-np.ones(n - 1), 3.0 * np.ones(n), -np.ones(n - 1)], [-1, 0, 1]).tocsr()


def _hofstadter(nx=10, ny=10):
	from chip_smoke import hofstadter_csr

	return hofstadter_csr(nx, ny, 0.2)


def _pair(kind):
	"""(JAX operator, port operator, dense matrix) of one test operator."""
	if kind == "dense":
		A, _ = _spd(64, seed=2)
		return pt.operators.aslinop(jnp.asarray(A)), DenseOperator(A, device="cpu"), A
	H = _path(120) if kind == "dia" else _hofstadter()
	return JaxDIA.from_scipy(H), DIAOperator.from_scipy(H, device="cpu"), H.toarray()


@pytest.fixture
def jax_probes(monkeypatch):
	"""The port's moment sweeps draw the JAX package's probe block (``as_key(seed)``)."""

	def probes(op, nv, pdf, seed):
		dt = jnp.complex128 if op.dtype.is_complex else jnp.float64
		V = jax_sample(as_key(seed), (op.shape[0], int(nv)), pdf=pdf, dtype=dt if pdf == "phase" else jax_real_dtype(dt))
		return torch.from_numpy(np.array(V.astype(dt)))

	monkeypatch.setattr(kpm, "_probes", probes)


# --- coefficients --------------------------------------------------------------


def test_jackson_coefficients_match_jax():
	g = kpm.jackson_coefficients(50)
	assert g.dtype == torch.float64 and g.shape == (50,)
	_close(g.numpy(), np.asarray(jax_kpm.jackson_coefficients(50)), rtol=1e-13)
	assert abs(float(g[0]) - 1.0) < 1e-6 and float(g[-1]) < 0.01 and bool(torch.all(torch.diff(g) < 1e-9))


@pytest.mark.parametrize("fun", ["exp", "log", "stacked"])
def test_chebyshev_coefficients_match_jax(fun):
	port_f = ptt.stacked("exp", -np.array([0.5, 1.0, 2.0])) if fun == "stacked" else ptt.special.param_callable(fun)
	jax_f = pt.stacked("exp", -np.array([0.5, 1.0, 2.0])) if fun == "stacked" else pt.special.param_callable(fun)
	got = kpm._chebyshev_coefficients(port_f, 48, 1.25, 0.75)
	_close(got, jax_kpm._chebyshev_coefficients(jax_f, 48, 1.25, 0.75), rtol=1e-12, atol=1e-15)
	assert got.shape == ((3, 48) if fun == "stacked" else (48,))


@pytest.mark.parametrize("case", [("exp", (0.0, 1.0), 1e-8, "none"), ("exp", (0.0, 30.0), 1e-8, "none"),
	("exp", (0.0, 1.0), 1e-12, "none"), ("exp", (0.4, 2.1), 1e-3, "jackson"), ("log", (0.5, 2.0), 1e-6, "jackson")],
	ids=lambda c: f"{c[0]}-{c[1][1]}-{c[2]}-{c[3]}")
def test_suggest_chebyshev_degree_matches_jax(case):
	fun, interval, rtol, damping = case
	got = ptt.suggest_chebyshev_degree(fun, interval, rtol=rtol, damping=damping)
	assert got == pt.suggest_chebyshev_degree(fun, interval, rtol=rtol, damping=damping)
	if interval == (0.0, 1.0) and rtol == 1e-8:
		assert 5 <= got <= 40 and ptt.suggest_chebyshev_degree("exp", (0.0, 30.0)) > got


# --- moments, kpm_trace, kpm_density on JAX's probes ------------------------------


@pytest.mark.parametrize("interval", [(0.2, 2.4), "gershgorin"], ids=["explicit", "gershgorin"])
@pytest.mark.parametrize("case", [("dense", "rademacher"), ("dia", "normal"), ("hofstadter", "phase"), ("hofstadter", "rademacher")],
	ids=lambda c: "-".join(c))
def test_chebyshev_moments_match_jax(jax_probes, case, interval):
	kind, pdf = case
	jop, op, _ = _pair(kind)
	if kind == "hofstadter" and interval != "gershgorin":
		interval = (-4.2, 4.2)
	mus, bounds = kpm.chebyshev_moments(op, m=24, nv=16, pdf=pdf, interval=interval, seed=SEED)
	want, jbounds = jax_kpm.chebyshev_moments(jop, m=24, nv=16, pdf=pdf, interval=interval, seed=SEED)
	_close(bounds, jbounds, rtol=1e-14)
	_close(mus, want, rtol=1e-10, atol=1e-10)
	assert mus.dtype == np.float64 and abs(mus[0] - op.shape[0]) < (1e-9 if pdf != "normal" else 0.5 * op.shape[0])


@pytest.mark.parametrize("fun", ["log", "family", "stacked", "auto"])
def test_kpm_trace_matches_jax(jax_probes, fun):
	jop, op, A = _pair("dense")
	kw = dict(m=48, nv=16, interval=(0.4, 2.1), seed=SEED)
	if fun == "family":
		taus = [0.5, 1.0, 2.0]
		port_f = [(lambda t: (lambda x: torch.exp(-t * x)))(t) for t in taus]
		jax_f = [(lambda t: (lambda x: jnp.exp(-t * x)))(t) for t in taus]
	elif fun == "stacked":
		port_f, jax_f = ptt.stacked("exp", -np.array([0.5, 1.0])), pt.stacked("exp", -np.array([0.5, 1.0]))
	else:
		port_f = jax_f = "exp" if fun == "auto" else fun
		if fun == "auto":
			kw["m"] = "auto"
	got = ptt.kpm_trace(op, port_f, **kw)
	want = pt.kpm_trace(jop, jax_f, **kw)
	if fun in ("log", "auto"):
		assert isinstance(got, float)
	else:
		assert got.shape == np.asarray(want).shape and got.shape[0] > 1
	_close(got, want, rtol=1e-10)


def test_kpm_trace_complex_matches_jax(jax_probes):
	"""The tight-binding path: phase probes, undamped, the Gershgorin interval; traces of
	H² and H⁴, whose closed forms are 4n and (28 + 8 cos 2πα)·n on a periodic lattice."""
	jop, op, _ = _pair("hofstadter")
	n = op.shape[0]
	funs_p, funs_j = [lambda x: x**2, lambda x: x**4], [lambda x: x**2, lambda x: x**4]
	kw = dict(m=8, nv=16, damping="none", interval="gershgorin", pdf="phase", seed=SEED)
	got = ptt.kpm_trace(op, funs_p, **kw)
	_close(got, pt.kpm_trace(jop, funs_j, **kw), rtol=1e-10)
	exact = np.array([4.0 * n, (28.0 + 8.0 * np.cos(2 * np.pi * 0.2)) * n])
	assert np.all(np.abs(got - exact) / exact < 0.05)


@pytest.mark.parametrize("kind", ["dense", "hofstadter"])
def test_kpm_density_matches_jax(jax_probes, kind):
	jop, op, _ = _pair(kind)
	pdf, interval = ("phase", "gershgorin") if kind == "hofstadter" else ("rademacher", (0.0, 2.5))
	ts, phi = ptt.kpm_density(op, grid=200, m=64, nv=16, pdf=pdf, interval=interval, seed=SEED)
	tsj, phij = pt.kpm_density(jop, grid=200, m=64, nv=16, pdf=pdf, interval=interval, seed=SEED)
	_close(ts, tsj, rtol=1e-14)
	_close(phi, phij, rtol=1e-9, atol=1e-12)
	assert abs(np.trapezoid(phi, ts) - 1.0) < 0.05


def test_kpm_trace_differentiable_gradient_matches_jax(jax_probes):
	"""``kpm_trace(differentiable=True)`` on a real DIA operator whose bands require a
	gradient, against ``jax.grad`` of the JAX package's traced estimate, same probes."""
	n, offsets = 80, (-7, -1, 0, 1, 7)
	rng = np.random.default_rng(3)
	bands = rng.uniform(-0.3, 0.3, (len(offsets), n))
	bands[2] = rng.uniform(1.5, 2.5, n)
	interval, m, nv = (0.0, 4.5), 24, 8

	def jax_est(b):
		op = JaxDIA(b, offsets, (n, n))
		return pt.kpm_trace(op, "log", m=m, nv=nv, interval=interval, seed=SEED, differentiable=True)

	want, jgrad = jax.value_and_grad(jax_est)(jnp.asarray(bands))
	b = torch.tensor(bands, requires_grad=True)
	got = ptt.kpm_trace(DIAOperator(b, offsets, (n, n)), "log", m=m, nv=nv, interval=interval, seed=SEED, differentiable=True)
	assert got.ndim == 0 and got.requires_grad
	(grad,) = torch.autograd.grad(got, b)
	_close(float(got.detach()), float(want), rtol=1e-10)
	_close(grad.numpy(), np.asarray(jgrad), rtol=1e-8, atol=1e-12)
	with pytest.raises(ValueError, match="interval"):
		ptt.kpm_trace(DIAOperator(b, offsets, (n, n)), "log", m=m, differentiable=True)
	with pytest.raises(ValueError, match="degree"):
		ptt.kpm_trace(DIAOperator(b, offsets, (n, n)), "log", m="auto", interval=interval, differentiable=True)


# --- ChebyshevFunction -----------------------------------------------------------


@pytest.mark.parametrize("damping", ["jackson", "none"])
@pytest.mark.parametrize("kind", ["dense", "hofstadter"])
def test_chebyshev_function_matches_jax(kind, damping):
	jop, op, _ = _pair(kind)
	interval = "gershgorin" if kind == "hofstadter" else (0.3, 2.2)
	n = op.shape[0]
	rng = np.random.default_rng(5)
	V = rng.normal(size=(n, 4)) + (1j * rng.normal(size=(n, 4)) if kind == "hofstadter" else 0.0)
	C = ChebyshevFunction(op, "exp", deg=32, interval=interval, damping=damping)
	Cj = pt.ChebyshevFunction(jop, "exp", deg=32, interval=interval, damping=damping)
	assert C.interval == Cj.interval and C.stack_shape == Cj.stack_shape == ()
	_close(C.matmat(torch.from_numpy(V)).numpy(), np.asarray(Cj.matmat(jnp.asarray(V))), rtol=0, atol=1e-10)
	_close((C @ torch.from_numpy(V[:, 0])).numpy(), np.asarray(Cj @ jnp.asarray(V[:, 0])), rtol=0, atol=1e-10)
	q = C.quad(torch.from_numpy(V))
	assert q.dtype == torch.float64
	_close(q.numpy(), np.asarray(Cj.quad(jnp.asarray(V))), rtol=1e-10)
	# A family shares the recurrence and gains a leading axis.
	Cf = ChebyshevFunction(op, ["exp", "identity"], deg=16, interval=interval, damping=damping)
	Cfj = pt.ChebyshevFunction(jop, ["exp", "identity"], deg=16, interval=interval, damping=damping)
	assert Cf.stack_shape == (2,)
	_close(Cf.matmat(torch.from_numpy(V)).numpy(), np.asarray(Cfj.matmat(jnp.asarray(V))), rtol=0, atol=1e-10)
	_close(Cf.quad(torch.from_numpy(V)).numpy(), np.asarray(Cfj.quad(jnp.asarray(V))), rtol=1e-10)


def test_chebyshev_function_is_exact_at_full_degree_on_a_hermitian_operator():
	rng = np.random.default_rng(70)
	n = 96
	ew = rng.uniform(-1.5, 1.5, n)
	A = np.array(pt.hermitian(n, ew=ew, seed=71))
	lam, U = np.linalg.eigh(A)
	C = ChebyshevFunction(torch.from_numpy(A), fun="exp", deg=64, damping="none")
	v = rng.normal(size=n) + 1j * rng.normal(size=n)
	_close((C @ torch.from_numpy(v)).numpy(), (U * np.exp(lam)) @ U.conj().T @ v, rtol=0, atol=1e-10)
	W = rng.normal(size=(n, 4))
	q = C.quad(torch.from_numpy(W))
	assert q.dtype == torch.float64
	_close(q.numpy(), np.einsum("ij,ij->j", W, (((U * np.exp(lam)) @ U.conj().T) @ W).real), rtol=0, atol=1e-8)
	t = ptt.kpm_trace(torch.from_numpy(A), fun="exp", m=64, nv=64, seed=72)
	assert abs(t - np.exp(lam).sum()) / np.exp(lam).sum() < 0.05
	tp = ptt.kpm_trace(torch.from_numpy(A), fun="exp", m=48, nv=64, pdf="phase", seed=94)
	assert abs(tp - np.exp(lam).sum()) / np.exp(lam).sum() < 0.08


def test_chebyshev_quad_agrees_with_its_matvec():
	A, _ = _spd(64, seed=5)
	M = ChebyshevFunction(torch.from_numpy(A), fun="exp", deg=48, seed=0)
	V = np.random.default_rng(6).normal(size=(64, 4))
	direct = np.einsum("ij,ij->j", V, M.matmat(torch.from_numpy(V)).numpy())
	_close(M.quad(torch.from_numpy(V)).numpy(), direct, rtol=1e-5, atol=1e-6)


# --- the reference tests' statistical bars, on the port alone ---------------------


@pytest.mark.parametrize("case", ["logdet", "identity", "dia_logdet", "hutch_is_kpm", "family"])
def test_kpm_meets_the_reference_bars(case):
	if case in ("dia_logdet", "hutch_is_kpm"):
		n = 256
		op = DIAOperator.from_scipy(_path(n), device="cpu")
		k = np.arange(1, n + 1)
		exact = float(np.sum(np.log(3.0 - 2.0 * np.cos(k * np.pi / (n + 1)))))
		if case == "dia_logdet":
			est = ptt.kpm_trace(op, fun="log", m=96, nv=64, seed=7)
		else:
			est = ptt.hutch(ChebyshevFunction(op, fun="log", deg=96, seed=7), batch=64, converge="count", count=128, seed=11)
		assert abs(est - exact) / abs(exact) < 0.1
		return
	A, ew = _spd(100 if case == "family" else 96, seed=9 if case == "family" else 3)
	A = torch.from_numpy(A)
	if case == "logdet":
		assert abs(ptt.kpm_trace(A, fun="log", m=96, nv=64, seed=2) - np.log(ew).sum()) / abs(np.log(ew).sum()) < 0.1
	elif case == "identity":
		assert abs(ptt.kpm_trace(A, fun="identity", m=32, nv=64, seed=4) - ew.sum()) / ew.sum() < 0.1
	else:
		ts = [0.5, 1.0, 2.0]
		funs = [(lambda t: (lambda x: np.exp(-t * x)))(t) for t in ts]
		ests = ptt.kpm_trace(A, funs, m=96, nv=64, seed=1)
		assert ests.shape == (3,)
		_close(ests, [np.sum(np.exp(-t * ew)) for t in ts], rtol=0.1)
		e0 = ptt.kpm_trace(A, funs[0], m=96, nv=64, seed=1)
		assert isinstance(e0, float) and np.isclose(e0, ests[0], rtol=1e-12)


def test_kpm_density_and_auto_degree_meet_the_reference_bars():
	A, ew = _spd(seed=5, lo=1.0, hi=1.2)
	ts, phi = ptt.kpm_density(torch.from_numpy(A), grid=400, m=128, nv=32, interval=(0.0, 2.0), seed=6)
	dt = ts[1] - ts[0]
	assert abs(phi.sum() * dt - 1.0) < 0.1
	assert phi[(ts > 0.9) & (ts < 1.3)].sum() * dt > 0.8
	rng = np.random.default_rng(7)
	ew = rng.uniform(0.1, 2.0, 64)
	S = ptt.symmetric(64, ew=ew, seed=9, dtype=torch.float64, device="cpu")
	true = np.exp(ew).sum()
	assert abs(ptt.kpm_trace(S, "exp", m="auto", nv=64, seed=11) - true) <= 0.05 * true
	M = ChebyshevFunction(S, "exp", deg="auto", seed=13)
	assert M.degree >= 5
	assert abs(ptt.hutch(M, converge="count", count=256, seed=15) - true) <= 0.05 * true
	# Sizing against the Jackson-damped error meets a 1e-3 bar; the undamped one a 1e-6 bar.
	B = ptt.symmetric(64, pd=True, ew=np.linspace(0.4, 2.1, 64), seed=0, dtype=torch.float64, device="cpu")
	v = torch.from_numpy(np.random.default_rng(1).normal(size=64))
	w, U = torch.linalg.eigh(B)
	truth = U @ (torch.exp(w) * (U.T @ v))
	cf_j = ChebyshevFunction(B, "exp", deg="auto", interval=(0.4, 2.1), damping="jackson")
	cf_n = ChebyshevFunction(B, "exp", deg="auto", interval=(0.4, 2.1), damping="none")
	assert float(torch.linalg.norm(cf_j @ v - truth) / torch.linalg.norm(truth)) < 2e-3
	assert cf_n.degree < cf_j.degree and float(torch.linalg.norm(cf_n @ v - truth) / torch.linalg.norm(truth)) < 1e-6


def test_default_interval_brackets_the_spectrum():
	"""``interval=None``: the Rayleigh-Ritz bracket, 3% wider than the extreme Ritz values."""
	A, ew = _spd(24, seed=4)
	lo, hi = kpm._resolve_interval(DenseOperator(A, device="cpu"), None, 1)
	span = ew.max() - ew.min()
	assert lo < ew.min() < lo + 0.05 * span and hi - 0.05 * span < ew.max() < hi


# --- spectral densities ------------------------------------------------------------


@pytest.fixture
def jax_density_probes(monkeypatch):
	"""``spectral_density`` draws the JAX package's probe block ``as_key(seed)``."""

	def sample(generator, shape, pdf="rademacher", dtype=None):
		return torch.from_numpy(np.array(jax_sample(sample.key, shape, pdf=pdf, dtype=jnp.float64)))

	monkeypatch.setattr(port_density, "sample_isotropic", sample)
	return sample


@pytest.mark.parametrize("case", [dict(orth=0), dict(orth=-1, sigma=0.1, bounds=(-0.5, 2.5)), dict(orth=5, grid=np.linspace(0, 2, 50))],
	ids=["orth0", "full-bounds", "grid"])
def test_spectral_density_matches_jax(jax_density_probes, case):
	n = 96
	ew = np.random.default_rng(0).uniform(0.0, 2.0, n)
	A = np.array(pt.symmetric(n, ew=ew, seed=0))
	jax_density_probes.key = as_key(SEED)
	kw = dict(deg=32, nv=8, seed=SEED, **case)
	ts, phi = ptt.spectral_density(torch.from_numpy(A), **kw)
	tsj, phij = pt.spectral_density(jnp.asarray(A), **kw)
	_close(ts, tsj, rtol=1e-12, atol=1e-14)
	_close(phi, phij, rtol=1e-9, atol=1e-12)
	tc, csm = ptt.cumulative_spectral_density(torch.from_numpy(A), **kw)
	_close(csm, jax_density.cumulative_spectral_density(jnp.asarray(A), **kw)[1], rtol=1e-9, atol=1e-12)
	q = ptt.spectral_quantile(torch.from_numpy(A), [0.25, 0.5], **{k: v for k, v in kw.items() if k != "grid"})
	_close(q, pt.spectral_quantile(jnp.asarray(A), [0.25, 0.5], **{k: v for k, v in kw.items() if k != "grid"}), rtol=1e-9)


def test_spectral_density_complex_matches_jax(jax_density_probes):
	"""The Hermitian sweep of ``spectral_density`` (real probes cast to the operator's dtype)."""
	H = _hofstadter()
	jop, op = JaxDIA.from_scipy(H), DIAOperator.from_scipy(H, device="cpu")
	jax_density_probes.key = as_key(SEED)
	ts, phi = ptt.spectral_density(op, deg=24, nv=8, seed=SEED)
	tsj, phij = pt.spectral_density(jop, deg=24, nv=8, seed=SEED)
	_close(ts, tsj, rtol=1e-12, atol=1e-14)
	_close(phi, phij, rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("case", ["broadened", "bimodal", "cumulative", "auto_bounds", "two_lobe_complex", "quantiles"])
def test_spectral_density_meets_the_reference_bars(case):
	rng = np.random.default_rng(0)
	sym = lambda n, ew, seed: ptt.symmetric(n, ew=ew, seed=seed, dtype=torch.float64, device="cpu")  # noqa: E731
	if case == "broadened":
		ew = rng.uniform(0.0, 2.0, 128)
		ts, phi = ptt.spectral_density(sym(128, ew, 0), grid=200, deg=64, nv=32, sigma=0.1, bounds=(-0.5, 2.5), orth=-1, seed=1)
		z = (ts[None, :] - ew[:, None]) / 0.1
		exact = (np.exp(-0.5 * z * z) / (0.1 * np.sqrt(2 * np.pi))).mean(axis=0)
		dt = ts[1] - ts[0]
		assert np.abs(phi - exact).sum() * dt < 0.12 and abs(phi.sum() * dt - 1.0) < 0.05
	elif case == "bimodal":
		ew = np.r_[np.random.default_rng(1).normal(-2.0, 0.1, 50), np.random.default_rng(2).normal(2.0, 0.1, 50)]
		ts, phi = ptt.spectral_density(sym(100, ew, 3), grid=300, deg=40, nv=16, sigma=0.15, bounds=(-3.5, 3.5), orth=-1, seed=4)
		mid = phi[(ts > -1) & (ts < 1)].mean()
		assert phi[np.abs(ts + 2) < 0.2].mean() > 10 * mid and phi[np.abs(ts - 2) < 0.2].mean() > 10 * mid
	elif case == "cumulative":
		S = ptt.symmetric(64, pd=True, seed=5, dtype=torch.float64, device="cpu")
		ts, csm = ptt.cumulative_spectral_density(S, grid=128, deg=48, nv=8, orth=-1, seed=6)
		assert np.all(np.diff(csm) >= -1e-9) and 0.9 < csm[-1] < 1.1
	elif case == "auto_bounds":
		ew = np.random.default_rng(7).uniform(1.0, 3.0, 80)
		ts, _ = ptt.spectral_density(sym(80, ew, 7), deg=40, nv=8, orth=-1, seed=8)
		assert ts[0] <= 1.05 and ts[-1] >= 2.95
	elif case == "two_lobe_complex":
		n = 128
		ew = np.concatenate([rng.uniform(0.0, 0.5, n // 2), rng.uniform(1.5, 2.0, n // 2)])
		A = torch.from_numpy(np.array(pt.hermitian(n, ew=ew, seed=16)))
		ts, phi = ptt.spectral_density(A, deg=48, nv=8, seed=17)
		assert np.all(np.isfinite(phi)) and phi[(ts > 0.8) & (ts < 1.2)].mean() < 0.2 * phi[(ts > 0.0) & (ts < 0.5)].mean()
	else:
		n = 256
		A = sym(n, (np.arange(n) + 0.5) / n, 1)
		t = ptt.spectral_quantile(A, np.asarray([0.25, 0.5, 0.75]), deg=64, nv=32, seed=3)
		assert np.all(np.abs(t - [0.25, 0.5, 0.75]) < 0.08)
		med = ptt.spectral_quantile(A, 0.5, deg=64, nv=32, seed=3)
		assert isinstance(med, float) and abs(med - 0.5) < 0.08
		ew = np.concatenate([np.full(100, 1.0), np.full(100, 5.0)]) + np.random.default_rng(5).normal(0, 0.02, 200)
		B = sym(200, ew, 7)
		assert abs(ptt.spectral_quantile(B, 0.2, deg=48, nv=32, seed=9) - 1.0) < 0.3
		assert abs(ptt.spectral_quantile(B, 0.8, deg=48, nv=32, seed=9) - 5.0) < 0.3
