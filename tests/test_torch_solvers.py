"""The port's batched CG, Jacobi and Nyström preconditioners and differentiable solve
against ``primate_tpu.solvers`` on the same numpy inputs (float64, n ≤ 400).

Tolerances: solutions 1e-8 relative to their largest entry; gradients 1e-7; the
preconditioners' applies 1e-10; float32 Nyström 1e-4.
"""

import warnings

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import jax
import jax.numpy as jnp

import primate_tpu as pt
from primate_tpu import solvers as jsol
from primate_tpu.random import as_key
from primate_tpu.random import sample_isotropic as jax_sample
from primate_tpu_torch import CSROperator, DIAOperator, cg, diag_precond_from_numpy, nystrom_from_numpy, nystrom_precond, solve
from primate_tpu_torch import solvers
from primate_tpu_torch.operators.base import DenseOperator

torch.set_num_threads(1)
SOL_RTOL, GRAD_RTOL = 1e-8, 1e-7


def _close(got, want, rtol):
	got, want = np.asarray(got, dtype=float), np.asarray(want, dtype=float)
	assert got.shape == want.shape
	assert np.max(np.abs(got - want)) <= rtol * max(np.max(np.abs(want)), 1e-300)


def _spd(n, ew, seed=0):
	Q, _ = np.linalg.qr(np.random.default_rng(seed).normal(size=(n, n)))
	return (Q * ew) @ Q.T


def _banded(n, seed=0):
	rng = np.random.default_rng(seed)
	offs = (-7, -1, 1, 7)
	A = sps.diags([rng.uniform(-1, 1, n - abs(o)) for o in offs], offs, shape=(n, n))
	A = 0.5 * (A + A.T)
	return (A + sps.diags(np.abs(A).sum(axis=1).A.ravel() + 0.2)).tocsr()


def _pair(kind, n=300):
	"""(JAX operator, port operator, dense matrix) of one SPD matrix."""
	if kind == "dense":
		A = _spd(n, np.geomspace(0.1, 50.0, n))
		return jnp.asarray(A), DenseOperator(torch.from_numpy(A)), A
	A = _banded(n)
	if kind == "dia":
		return pt.operators.sparse.DIAOperator.from_scipy(A), DIAOperator.from_scipy(A, device="cpu"), A.toarray()
	return pt.operators.sparse.CSROperator.from_scipy(A), CSROperator.from_scipy(A, device="cpu"), A.toarray()


@pytest.mark.parametrize("k", [None, 5])
@pytest.mark.parametrize("kind", ["dense", "dia", "csr"])
def test_cg_matches_jax(kind, k):
	jop, op, A = _pair(kind)
	rng = np.random.default_rng(1)
	B = rng.normal(size=A.shape[0] if k is None else (A.shape[0], k))
	got = cg(op, torch.from_numpy(B), rtol=1e-11)
	want = jsol.cg(jop, jnp.asarray(B), rtol=1e-11)
	assert got.shape == B.shape
	_close(got, want, SOL_RTOL)
	_close(got, np.linalg.solve(A, B), 1e-8)


@pytest.mark.parametrize("precond", [None, "jacobi"])
def test_full_reports_the_iterations_and_residuals_of_jax(precond):
	jop, op, A = _pair("dia")
	B = np.random.default_rng(2).normal(size=(A.shape[0], 4))
	X, it, res = cg(op, torch.from_numpy(B), rtol=1e-9, full=True, precond=precond)
	jX, jit, jres = jsol.cg(jop, jnp.asarray(B), rtol=1e-9, full=True, precond=precond)
	assert it == jit and res.shape == (4,)
	_close(X, jX, SOL_RTOL)
	# Both report the loop's recursive residual.
	np.testing.assert_allclose(res, jres, rtol=1e-8)
	np.testing.assert_allclose(res, np.linalg.norm(B - A @ X.numpy(), axis=0), rtol=1e-6)
	assert np.all(res <= 1.001e-9 * np.linalg.norm(B, axis=0))
	_, it_cap, _ = cg(op, torch.from_numpy(B), rtol=1e-14, maxiter=3, full=True)
	assert it_cap == 3


def test_warm_start_stops_at_the_documented_tolerance():
	"""The shifted system stops at ‖B − A X‖ ≤ rtol·‖B‖ (not rtol·‖B − A X0‖), as in JAX."""
	jop, op, A = _pair("dense")
	rng = np.random.default_rng(3)
	B = rng.normal(size=(A.shape[0], 3))
	X0 = np.linalg.solve(A, B) + 1e-3 * rng.normal(size=B.shape)
	rtol = 1e-6
	got = cg(op, torch.from_numpy(B), X0=torch.from_numpy(X0), rtol=rtol)
	want = jsol.cg(jop, jnp.asarray(B), X0=jnp.asarray(X0), rtol=rtol)
	_close(got, want, SOL_RTOL)
	res = np.linalg.norm(B - A @ got.numpy(), axis=0) / np.linalg.norm(B, axis=0)
	assert np.all(res <= rtol * 1.01) and np.all(res >= 1e-3 * rtol)  # stopped near rtol, not far below it
	_, it_cold, _ = cg(op, torch.from_numpy(B), rtol=rtol, full=True)
	_, it_warm, _ = cg(op, torch.from_numpy(B), X0=torch.from_numpy(X0), rtol=rtol, full=True)
	assert it_warm < it_cold


@pytest.mark.parametrize("stochastic", [False, True])
def test_jacobi_weights_floor_policy_matches_jax(stochastic):
	"""A wide dynamic range (1e-12 … 1e6), a zero and a negative entry: exact diagonals keep
	1/d down to an eps-relative floor, stochastic ones floor at 1e-3·mean|d|."""
	d = np.r_[np.geomspace(1e-12, 1e6, 40), 0.0, -3.0]
	with warnings.catch_warnings(record=True) as caught:
		warnings.simplefilter("always")
		got = solvers._jacobi_weights(torch.from_numpy(d), stochastic, torch.float64)
	want = jsol._jacobi_weights(jnp.asarray(d), stochastic, jnp.float64)
	_close(got, want, 1e-12)
	n_floored = int(np.sum(d <= (1e-3 if stochastic else np.finfo(np.float64).eps) * np.mean(np.abs(d))))
	assert any(f"{n_floored} non-positive" in str(w.message) for w in caught)
	# cg with the diagonal of a wide-range operator, exact (extracted) and as a user array.
	n = 200
	A = sps.diags(np.geomspace(1e-3, 1e5, n)) + sps.diags([0.1 * np.ones(n - 1)] * 2, [-1, 1])
	jop, op = pt.operators.sparse.DIAOperator.from_scipy(A), DIAOperator.from_scipy(A, device="cpu")
	B = np.random.default_rng(4).normal(size=(n, 2))
	for precond in ("jacobi", A.diagonal()):
		got = cg(op, torch.from_numpy(B), rtol=1e-10, precond=precond if isinstance(precond, str) else torch.from_numpy(precond))
		want = jsol.cg(jop, jnp.asarray(B), rtol=1e-10, precond=precond if isinstance(precond, str) else jnp.asarray(precond))
		_close(got, want, SOL_RTOL)


def test_stochastic_diagonal_for_a_large_csr_operator():
	"""Past 4,096 rows a CSR operator's Jacobi diagonal is estimated (count 256, seed 0), and
	flagged stochastic: the floor policy of stochastic estimates applies."""
	n = 5000
	A = sps.diags([np.full(n - 1, -1.0), np.linspace(2.5, 30.0, n), np.full(n - 1, -1.0)], [-1, 0, 1]).tocsr()
	op = CSROperator.from_scipy(A, device="cpu")
	d, stochastic = solvers._operator_diagonal(op)
	assert stochastic and d.shape == (n,)
	assert float(torch.max(torch.abs(d - torch.from_numpy(A.diagonal())) / torch.from_numpy(A.diagonal()))) < 0.5
	B = np.random.default_rng(5).normal(size=n)
	X = cg(op, torch.from_numpy(B), rtol=1e-8, precond="jacobi")
	assert np.linalg.norm(B - A @ X.numpy()) <= 1.01e-8 * np.linalg.norm(B)


def _spectra(n):
	spiky = np.r_[np.geomspace(1e4, 1e2, 10), np.linspace(1.0, 2.0, n - 10)]
	deficient = np.r_[np.geomspace(1e3, 1.0, 20), np.zeros(n - 20)] + 1e-2  # rank 20 plus a small ridge
	return {"spiky": spiky, "rank_deficient": deficient}


@pytest.mark.parametrize("spectrum", ["spiky", "rank_deficient"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_nystrom_preconditioner_matches_jax_on_its_test_block(spectrum, dtype):
	"""JAX's Ω regenerated as ``solvers.py:85`` draws it and injected: the two
	preconditioners apply alike, and PCG with them gives the same solutions."""
	n, s = 300, 32
	A = _spd(n, _spectra(n)[spectrum], seed=6).astype(dtype)
	Om = np.array(jax_sample(as_key(7), (n, s), pdf="normal", dtype=jnp.dtype(dtype)))
	pre = solvers.nystrom_core(DenseOperator(torch.from_numpy(A)), torch.from_numpy(Om))
	jpre = jsol.nystrom_precond(jnp.asarray(A), rank=s, seed=7)
	R = np.random.default_rng(8).normal(size=(3, n)).astype(dtype)
	tol = 1e-10 if dtype == np.float64 else 1e-4
	_close(pre.apply_t(torch.from_numpy(R)), jpre.apply_t(jnp.asarray(R)), tol)
	carried = nystrom_from_numpy(np.asarray(jpre.U), np.asarray(jpre.coef), device="cpu")
	_close(carried.apply_t(torch.from_numpy(R)), jpre.apply_t(jnp.asarray(R)), 1e-12 if dtype == np.float64 else 1e-6)
	if dtype == np.float64:
		B = np.random.default_rng(9).normal(size=(n, 2))
		X, it, _ = cg(DenseOperator(torch.from_numpy(A)), torch.from_numpy(B), rtol=1e-10, precond=pre, full=True)
		jX, jit, _ = jsol.cg(jnp.asarray(A), jnp.asarray(B), rtol=1e-10, precond=jpre, full=True)
		_close(X, jX, SOL_RTOL)
		_, it_plain, _ = cg(DenseOperator(torch.from_numpy(A)), torch.from_numpy(B), rtol=1e-10, full=True)
		assert it < it_plain


def test_nystrom_precond_on_the_card_default_and_a_seed():
	A = _spd(120, np.geomspace(1.0, 1e3, 120), seed=10)
	pre = nystrom_precond(A, rank=16, seed=3, device="cpu")
	again = nystrom_precond(torch.from_numpy(A), rank=16, seed=3)
	assert pre.U.shape == (120, 16) and torch.equal(pre.coef, again.coef)
	X = cg(A, np.ones(120), rtol=1e-10, precond="nystrom", precond_rank=16, precond_seed=3, device="cpu")
	_close(X, np.linalg.solve(A, np.ones(120)), 1e-8)
	carried = diag_precond_from_numpy(1.0 / np.diag(A), device="cpu")
	_close(cg(A, np.ones(120), rtol=1e-11, precond=carried, device="cpu"), np.linalg.solve(A, np.ones(120)), 1e-8)


@pytest.mark.parametrize("warm", [False, True])
def test_differentiable_solve_matches_jax_grad(warm):
	"""d/dθ of ``wᵀ solve(A(θ), b(θ))`` for a dense A and the DIA bands of a banded one,
	against ``jax.grad`` through ``custom_linear_solve``."""
	n = 80
	rng = np.random.default_rng(11)
	w, b0 = rng.normal(size=n), rng.normal(size=n)
	A0 = _spd(n, np.linspace(1.0, 10.0, n), seed=12)
	X0 = np.linalg.solve(A0, b0) + 1e-2 * rng.normal(size=n) if warm else None

	def jax_loss(A, b):
		x = jsol.solve(A, b, rtol=1e-12, X0=None if X0 is None else jnp.asarray(X0))
		return jnp.asarray(w) @ x

	jA, jb = jax.grad(jax_loss, argnums=(0, 1))(jnp.asarray(A0), jnp.asarray(b0))
	A = torch.tensor(A0, requires_grad=True)
	b = torch.tensor(b0, requires_grad=True)
	loss = torch.from_numpy(w) @ solve(DenseOperator(A), b, rtol=1e-12, X0=None if X0 is None else torch.from_numpy(X0))
	loss.backward()
	_close(A.grad, jA, GRAD_RTOL)
	_close(b.grad, jb, GRAD_RTOL)
	# DIA bands.
	S = _banded(n, seed=13)
	jop = pt.operators.sparse.DIAOperator.from_scipy(S)
	op = DIAOperator.from_scipy(S, device="cpu")
	bands = op.bands.clone().requires_grad_(True)
	loss = torch.from_numpy(w) @ solve(DIAOperator(bands, op.offsets, op.shape), torch.from_numpy(b0), rtol=1e-12)
	(g,) = torch.autograd.grad(loss, bands)
	jg = jax.grad(
		lambda bd: jnp.asarray(w) @ jsol.solve(pt.operators.sparse.DIAOperator(bd, jop.offsets, jop.shape), jnp.asarray(b0), rtol=1e-12)
	)(jop.bands)
	_close(g, jg, GRAD_RTOL)


def test_complex_operators_raise():
	"""A Hermitian (complex) solve runs, as in the JAX package (held to it in
	``test_torch_complex.py``), and, as there, is not differentiated: asking for its
	gradient raises."""
	rng = np.random.default_rng(14)
	A = np.array(pt.hermitian(6, ew=np.linspace(1.0, 2.0, 6), seed=2))
	b = rng.normal(size=6) + 1j * rng.normal(size=6)
	x = cg(torch.from_numpy(A), torch.from_numpy(b), rtol=1e-12)
	assert x.dtype == torch.complex128
	assert np.linalg.norm(A @ x.numpy() - b) <= 1e-10 * np.linalg.norm(b)
	with pytest.raises(NotImplementedError):
		solve(torch.from_numpy(A), torch.from_numpy(b).requires_grad_(True))
