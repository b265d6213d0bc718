"""The port's tridiagonal eigensolvers, FTTR and quadrature rules (Gauss, Gauss-Radau,
Gauss-Lobatto) against the JAX package, on the same numpy Jacobi matrices (f64, 1e-10)."""

import importlib
import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import primate_tpu.integrate as jint
import primate_tpu.tridiag as jtri
import primate_tpu_torch.integrate as tint
import primate_tpu_torch.tridiag as ttri

# Both packages export a function ``fttr`` that hides the module of that name.
jfttr, tfttr = importlib.import_module("primate_tpu.fttr"), importlib.import_module("primate_tpu_torch.fttr")

torch.set_num_threads(1)
TOL = 1e-10


def _jacobi(seed=0, nb=6, deg=12, spd=False):
	rng = np.random.default_rng(seed)
	d = rng.normal(size=(nb, deg))
	e = rng.uniform(0.1, 1.0, size=(nb, deg - 1))
	if spd:
		d = np.abs(d) + 4.0  # Gershgorin: eigenvalues in (2, 8)
	return d, e


def _close(got, want, tol=TOL, rtol=0.0):
	np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=tol)


@pytest.mark.parametrize("eigenvectors", [False, True])
def test_tqli_matches_jax(eigenvectors):
	"""The same QL sweeps leave the eigenvalues in the same (unsorted) order."""
	d, e = _jacobi()
	got = ttri.tqli(torch.from_numpy(d), torch.from_numpy(e), eigenvectors=eigenvectors)
	want = jtri.tqli(jnp.asarray(d), jnp.asarray(e), eigenvectors=eigenvectors)
	if eigenvectors:
		_close(got[0], want[0])
		_close(got[1], want[1])
		T = ttri.tridiag_matrix(torch.from_numpy(d), torch.from_numpy(e))
		rw, Z = got
		_close(T @ Z, Z * rw[:, None, :], 1e-9)
	else:
		_close(got, want)
		_close(np.sort(got.numpy(), axis=-1), np.linalg.eigvalsh(ttri.tridiag_matrix(torch.from_numpy(d), torch.from_numpy(e)).numpy()))


def test_tqli_single_matrix_and_leading_zero_offdiag():
	d, e = _jacobi(seed=1, nb=1)
	e_lead = np.concatenate([[0.0], e[0]])
	got = ttri.tqli(torch.from_numpy(d[0]), torch.from_numpy(e_lead), max_iter=40)
	_close(got, jtri.tqli(jnp.asarray(d[0]), jnp.asarray(e_lead), maxiter=40))


@pytest.mark.parametrize("method", ["auto", "eigh", "tqli"])
def test_eigvalsh_and_eigh_tridiag_match_jax(method):
	d, e = _jacobi(seed=2)
	got = ttri.eigvalsh_tridiag(torch.from_numpy(d), torch.from_numpy(e), method=method)
	want = jtri.eigvalsh_tridiag(jnp.asarray(d), jnp.asarray(e), method=method)
	_close(np.sort(got.numpy(), -1), np.sort(np.asarray(want), -1))
	rw, Y = ttri.eigh_tridiag(torch.from_numpy(d), torch.from_numpy(e), method=method)
	jrw, jY = jtri.eigh_tridiag(jnp.asarray(d), jnp.asarray(e), method=method)
	_close(rw, jrw)
	_close(np.abs(Y.numpy()), np.abs(np.asarray(jY)), 1e-9)  # eigenvectors up to sign
	with pytest.raises(ValueError):
		ttri.eigh_tridiag(torch.from_numpy(d), torch.from_numpy(e), method="lapack")


def test_tqli_warns_only_when_not_converged():
	d, e = _jacobi(seed=2)
	with warnings.catch_warnings():
		warnings.simplefilter("error")
		ttri.tqli(torch.from_numpy(d), torch.from_numpy(e))
	with pytest.warns(UserWarning, match="maxiter=1"):
		ttri.tqli(torch.from_numpy(d), torch.from_numpy(e), maxiter=1)


@pytest.mark.parametrize("quad", ["gw", "fttr"])
@pytest.mark.parametrize("deg", [None, 7])
def test_quadrature_matches_jax(quad, deg):
	d, e = _jacobi(seed=3, spd=True)
	theta, tau = tint.quadrature(torch.from_numpy(d), torch.from_numpy(e), deg=deg, quad=quad)
	jtheta, jtau = jint.quadrature(jnp.asarray(d), jnp.asarray(e), deg=deg, quad=quad)
	_close(theta, jtheta)
	_close(tau, jtau)
	np.testing.assert_allclose(tau.sum(-1).numpy(), 1.0, rtol=1e-10)  # a unit start vector's measure
	assert tint.lanczos_quadrature is tint.quadrature


def test_quadrature_fills_larger_outputs_like_jax():
	d, e = _jacobi(seed=4, nb=3, spd=True)
	nodes, weights = np.full((3, 20), -1.0), np.full((3, 20), -2.0)
	got = tint.quadrature(torch.from_numpy(d), torch.from_numpy(e), deg=5, nodes=torch.from_numpy(nodes), weights=torch.from_numpy(weights))
	want = jint.quadrature(jnp.asarray(d), jnp.asarray(e), deg=5, nodes=jnp.asarray(nodes), weights=jnp.asarray(weights))
	for g, w in zip(got, want):
		_close(g, w)
	assert np.all(got[0].numpy()[:, 5:] == -1.0) and np.all(nodes == -1.0)  # the caller's arrays stay as they were


def test_fttr_and_ortho_poly_match_jax():
	d, e = _jacobi(seed=5, nb=4, deg=9, spd=True)
	b = np.concatenate([np.zeros((4, 1)), e], axis=1)  # leading-slot convention
	theta = np.linalg.eigvalsh(ttri.tridiag_matrix(torch.from_numpy(d), torch.from_numpy(e)).numpy())
	_close(tfttr.fttr_weights(torch.from_numpy(theta), torch.from_numpy(d), torch.from_numpy(b)),
		jfttr.fttr_weights(jnp.asarray(theta), jnp.asarray(d), jnp.asarray(b)))
	_close(tfttr.fttr(torch.from_numpy(theta), torch.from_numpy(d), torch.from_numpy(b), k=6),
		jfttr.fttr(jnp.asarray(theta), jnp.asarray(d), jnp.asarray(b), k=6))
	x = np.linspace(2.0, 8.0, 11)  # the polynomials grow to ~1e5 here: relative tolerance
	want = jfttr.ortho_poly(jnp.asarray(x), 0.5, jnp.asarray(d[0]), jnp.asarray(b[0]))
	_close(tfttr.ortho_poly(torch.from_numpy(x), 0.5, torch.from_numpy(d[0]), torch.from_numpy(b[0])), want, 0.0, TOL)
	z = np.zeros((11, 9))
	assert tfttr.ortho_poly(torch.from_numpy(x), 0.5, torch.from_numpy(d[0]), torch.from_numpy(b[0]), z=z) is None
	_close(z, want, 0.0, TOL)


def test_radau_and_lobatto_rules_match_jax():
	"""Rules on the Jacobi matrices of SPD spectra in (2, 8), endpoints outside it."""
	d, e = _jacobi(seed=6, spd=True)
	beta_end = np.random.default_rng(7).uniform(0.2, 0.8, size=d.shape[0])
	args = (torch.from_numpy(d), torch.from_numpy(e), torch.from_numpy(beta_end))
	jargs = (jnp.asarray(d), jnp.asarray(e), jnp.asarray(beta_end))
	for x0 in (0.5, 10.0):
		nodes, weights = tint.radau_rule(*args, x0)
		jn, jw = jint.radau_rule(*jargs, x0)
		_close(nodes, jn)
		_close(weights, jw)
		assert np.all(np.min(np.abs(nodes.numpy() - x0), axis=-1) < 1e-9)  # a node sits at x0
	nodes, weights = tint.lobatto_rule(*args, 0.5, 10.0)
	jn, jw = jint.lobatto_rule(*jargs, 0.5, 10.0)
	_close(nodes, jn)
	_close(weights, jw)
	np.testing.assert_allclose(nodes.numpy()[:, [0, -1]], np.broadcast_to([0.5, 10.0], (d.shape[0], 2)), atol=1e-9)


def test_solve_shifted_on_a_singular_shift_gives_zero_like_jax():
	d = np.array([[0.0, 1.0, 2.0]])
	e = np.array([[0.0, 0.0]])  # diagonal: shift 0 hits an eigenvalue exactly
	got = tint._solve_shifted(torch.from_numpy(d), torch.from_numpy(e), torch.ones(1, dtype=torch.float64), 0.0)
	want = jint._solve_shifted(jnp.asarray(d), jnp.asarray(e), jnp.ones(1), 0.0)
	_close(got, want)
	assert float(got[0]) == 0.5  # the last row is regular: (2 − 0)·x = 1
	got = tint._solve_shifted(torch.from_numpy(d), torch.from_numpy(e), torch.ones(1, dtype=torch.float64), 2.0)
	want = jint._solve_shifted(jnp.asarray(d), jnp.asarray(e), jnp.ones(1), 2.0)
	_close(got, want)
	assert float(got[0]) == 0.0
