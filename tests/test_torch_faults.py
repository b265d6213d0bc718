"""Two faults of the port, each with its repair's tests.

* An estimator called without ``differentiable=True`` on an operator whose tensors require a gradient
  runs under ``torch.no_grad()``: it returns what the detached call returns, bit for bit on the same
  seed, and keeps no graph (it used to fail at its first copy to the host).
* A rectangular DIA operator applies: its bands lie on the square that holds it, the block is
  padded on the way in and cut on the way out, in both layouts and for both ``from_scipy`` engines.
  Its adjoint and its Gram operator are held to scipy's ``A.T @ U`` (the JAX package's adjoint of a
  rectangular DIA operator returns the wrong shape), and its applies to the JAX package's.
* A run that used up ``maxiter`` with its criterion unmet warns and labels its result as the JAX
  package does (``note_capped``): ``info["capped"]`` and ``[capped at maxiter=N]`` in ``message``.
"""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import jax.numpy as jnp

from primate_tpu.operators.sparse import DIAOperator as JaxDIA

import primate_tpu_torch as ptt
from primate_tpu_torch import recipes

torch.set_num_threads(2)
N = 60


def _op(requires_grad: bool):
	L = sps.diags([-np.ones(N - 1), 3.0 * np.ones(N), -np.ones(N - 1)], [-1, 0, 1])
	op = ptt.DIAOperator.from_scipy(L, dtype=torch.float64, device="cpu")
	if requires_grad:
		op.bands.requires_grad_()
	return op


_CALLS = {
	"hutch": lambda op: ptt.hutch(op, converge="count", count=16, seed=1),
	"hutch_slq": lambda op: ptt.hutch(ptt.MatrixFunction(op, "log", deg=10), converge="count", count=16, seed=1),
	"hutchpp": lambda op: ptt.hutchpp(op, seed=1),
	"hutchpp_adaptive": lambda op: ptt.hutchpp(op, m=9, seed=1, converge="count", count=8),
	"xtrace": lambda op: ptt.xtrace(op, seed=1),
	"xnystrace": lambda op: ptt.xnystrace(op, seed=1),
	"diag": lambda op: ptt.diag(op, converge="count", count=4, seed=1),
	"diag_slq": lambda op: ptt.diag(ptt.MatrixFunction(op, "log", deg=10), converge="count", count=3, seed=1),
	"diagpp": lambda op: ptt.diagpp(op, seed=1),
	"xdiag": lambda op: ptt.xdiag(op, seed=1),
	"logdet": lambda op: recipes.logdet(op, converge="count", count=16, seed=2),
	"spectral_density": lambda op: ptt.spectral_density(op, seed=1)[1],
}


@pytest.mark.parametrize("name", sorted(_CALLS))
def test_estimators_ignore_a_gradient_they_were_not_asked_for(name):
	got = _CALLS[name](_op(True))
	want = _CALLS[name](_op(False))
	assert not isinstance(got, torch.Tensor)
	assert np.array_equal(np.asarray(got), np.asarray(want))
	assert torch.is_grad_enabled()


def test_full_result_keeps_no_graph():
	op = _op(True)
	est, result = ptt.hutch(ptt.MatrixFunction(op, "log", deg=10), converge="count", count=16, seed=1, full=True)
	assert not result.estimator.state.mu.requires_grad and not result.estimator.state.S.requires_grad
	assert op.bands.grad is None


def test_differentiable_still_differentiates():
	op = _op(True)
	est = ptt.hutch(op, converge="count", count=16, seed=1, differentiable=True)
	est.backward()
	assert est.requires_grad and op.bands.grad is not None
	d = ptt.xdiag(op, seed=1, differentiable=True)
	assert d.requires_grad


def _difference(m: int, n: int):
	return sps.diags([-np.ones(m), np.ones(m)], [0, 1], shape=(m, n))


_RECT = {
	"tall_50x30": lambda: sps.random(50, 30, density=0.2, random_state=1),
	"wide_30x50": lambda: sps.random(30, 50, density=0.2, random_state=2),
	"difference_39x40": lambda: _difference(39, 40),
}


@pytest.mark.parametrize("engine", ["scipy", "native"])
@pytest.mark.parametrize("case", sorted(_RECT))
def test_rectangular_dia_applies_like_scipy(case, engine):
	A = sps.csr_matrix(_RECT[case]())
	m, n = A.shape
	op = ptt.DIAOperator.from_scipy(A, dtype=torch.float64, device="cpu", engine=engine)
	rng = np.random.default_rng(3)
	V, U = rng.normal(size=(n, 5)), rng.normal(size=(m, 5))
	Vt, Ut = torch.tensor(V.T.copy()), torch.tensor(U.T.copy())
	tol = 1e-12
	checks = [
		(op.matmat(torch.tensor(V)), A @ V),  # node-major
		(op.matmat(Vt.T), A @ V),  # probe-major
		(op.matmat_t(Vt), (A @ V).T),
		(op.matvec(torch.tensor(V[:, 0])), A @ V[:, 0]),
		(op.rmatmat(torch.tensor(U)), A.T @ U),
		(op.rmatmat(Ut.T), A.T @ U),
		(op.rmatmat_t(Ut), (A.T @ U).T),
		(op.rmatmat_plain(torch.tensor(U)), A.T @ U),
		(op.H.matmat(torch.tensor(U)), A.T @ U),
		(op.todense(), A.toarray()),
	]
	for got, want in checks:
		assert tuple(got.shape) == want.shape
		np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)
	for first, want in ((True, A.T @ (A @ V)), (False, A @ (A.T @ U))):
		G = ptt.GramOperator(op, transpose_first=first, device="cpu")
		X = V if first else U
		np.testing.assert_allclose(G.matmat(torch.tensor(X)).numpy(), want, rtol=0, atol=tol)
		np.testing.assert_allclose(G.matmat_t(torch.tensor(X.T.copy())).numpy(), want.T, rtol=0, atol=tol)


@pytest.mark.parametrize("case", sorted(_RECT))
def test_rectangular_dia_applies_like_jax(case):
	A = sps.csr_matrix(_RECT[case]())
	V = np.random.default_rng(4).normal(size=(A.shape[1], 3))
	op = ptt.DIAOperator.from_scipy(A, dtype=torch.float64, device="cpu")
	jop = JaxDIA.from_scipy(A, engine="native")
	np.testing.assert_allclose(op.matmat(torch.tensor(V)).numpy(), np.asarray(jop.matmat(jnp.asarray(V))), rtol=0, atol=1e-12)
	np.testing.assert_allclose(op.matmat_t(torch.tensor(V.T.copy())).numpy(), np.asarray(jop.matmat_t(jnp.asarray(V.T))), rtol=0, atol=1e-12)


def test_rectangular_dia_gram_quadrature_is_the_path_laplacian():
	"""The 39×40 difference operator's Gram operator ``DᵀD`` is the path Laplacian: its Gram
	quadrature of ``x`` on ``e_i`` probes gives the Laplacian's diagonal exactly."""
	D = ptt.DIAOperator.from_scipy(sps.csr_matrix(_difference(39, 40)), dtype=torch.float64, device="cpu")
	M = ptt.MatrixFunction(ptt.GramOperator(D, device="cpu"), "identity", deg=8)
	E = torch.eye(40, dtype=torch.float64)
	want = (_difference(39, 40).T @ _difference(39, 40)).diagonal()
	np.testing.assert_allclose(M.quad(E).numpy(), want, rtol=0, atol=1e-12)


def test_maxiter_capped_stop_is_surfaced():
	"""``tests/test_estimators.py:300-332`` on the port: a run that exhausts maxiter with its criterion
	unmet must warn and label the result, never silently read as converged."""
	import warnings as _w

	A = ptt.symmetric(32, pd=True, seed=0, device="cpu")
	# Tolerance impossible in 2 batches → capped.
	with pytest.warns(UserWarning, match="maxiter=2"):
		est, res = ptt.hutch(A, batch=4, converge="tolerance", atol=0.0, rtol=0.0, maxiter=2, seed=1, full=True)
	assert res.info.get("capped") is True
	assert "capped at maxiter=2" in res.message
	# full=False still warns.
	with pytest.warns(UserWarning, match="maxiter=2"):
		ptt.hutch(A, batch=4, converge="tolerance", atol=0.0, rtol=0.0, maxiter=2, seed=1)
	# A converged run carries no cap flag and no warning.
	with _w.catch_warnings():
		_w.simplefilter("error")
		est2, res2 = ptt.hutch(A, batch=4, converge="count", count=8, maxiter=64, seed=1, full=True)
	assert "capped" not in res2.info and "capped" not in res2.message

	# diag: fused path.
	with pytest.warns(UserWarning, match="diag: stopped by maxiter=3"):
		d, dres = ptt.diag(A, converge="tolerance", atol=0.0, rtol=0.0, maxiter=3, seed=2, full=True)
	assert dres.info.get("capped") is True and "capped at maxiter=3" in dres.message
	# diag: host-stepped path (callback forces it).
	with pytest.warns(UserWarning, match="diag: stopped by maxiter=3"):
		d2, dres2 = ptt.diag(A, converge="tolerance", atol=0.0, rtol=0.0, maxiter=3, seed=2, full=True, callback=lambda r: None)
	assert dres2.info.get("capped") is True
	# hutch: host-stepped path.
	with pytest.warns(UserWarning, match="hutch: stopped by maxiter=2"):
		ptt.hutch(A, batch=4, converge="tolerance", atol=0.0, rtol=0.0, maxiter=2, seed=1, callback=lambda r: None)


@pytest.mark.parametrize("fn", ["hutch", "diag"])
def test_differentiable_capped_budget_warns(fn):
	"""The fixed-budget ``differentiable=True`` paths warn through ``note_capped`` as JAX's do
	(``primate_tpu/trace.py:221``, ``primate_tpu/diagonal.py:102``)."""
	A = ptt.symmetric(16, pd=True, seed=0, device="cpu")
	with pytest.warns(UserWarning, match=f"{fn}: stopped by maxiter=2 before the convergence criterion was met; the estimate"):
		getattr(ptt, fn)(A, batch=2, converge="count", count=8, maxiter=2, seed=1, differentiable=True)
