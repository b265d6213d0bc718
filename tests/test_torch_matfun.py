"""The port's Lanczos API, matrix functions f(A)v and f(A) quadrature rules, stacked
families, criteria and estimators, and random test matrices against the JAX
package, on the same numpy inputs (f64 unless a test says otherwise).

Also the keyword rule: every keyword of the JAX ``MatrixFunction``, ``hutch``,
``diag``, ``lanczos`` and ``lanczos_block_op`` works as in JAX or raises
``NotImplementedError`` naming it, and an unknown keyword raises ``TypeError``."""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import jax.numpy as jnp

import primate_tpu as pt
from primate_tpu.lanczos import lanczos_block_op as jax_lanczos_block_op
from primate_tpu.operators.sparse import DIAOperator as JaxDIA
from primate_tpu_torch import (
	ConfidenceEstimator,
	ControlVariableEstimator,
	DIAOperator,
	Isotropic,
	MatrixFunction,
	OrthogonalPolynomialBasis,
	diag,
	haar,
	hutch,
	isotropic,
	lanczos,
	lanczos_block_op,
	matrix_function,
	rayleigh_ritz,
	stacked,
	symmetric,
)
from primate_tpu_torch.diagonal import run_diag
from primate_tpu_torch.estimators import CountCriterion, KneeCriterion, ToleranceCriterion
from primate_tpu_torch.operators.base import DenseOperator

torch.set_num_threads(1)
TAUS = np.geomspace(0.05, 4.0, 5)


def _path_laplacian(n):
	return sps.diags([-np.ones(n - 1), 3.0 * np.ones(n), -np.ones(n - 1)], [-1, 0, 1]).tocsr()


def _spd(n=80, seed=0, lo=0.5, hi=3.0):
	rng = np.random.default_rng(seed)
	Q, _ = np.linalg.qr(rng.normal(size=(n, n)))
	ew = rng.uniform(lo, hi, n)
	return (Q * ew) @ Q.T, ew


def _sampler(seed):
	rng = np.random.default_rng(seed)
	return lambda size: rng.choice([-1.0, 1.0], size=size)


def _close(got, want, tol, rtol=0.0):
	np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=tol)


# --- lanczos, rayleigh_ritz, the returned basis, coeffs ---------------------------------


@pytest.mark.parametrize("orth", [0, 3, -1])
def test_lanczos_single_and_block_match_jax(orth):
	A, _ = _spd()
	rng = np.random.default_rng(1)
	v0, V0 = rng.normal(size=80), rng.normal(size=(80, 4))
	for v in (v0, V0):
		a, b = lanczos(torch.from_numpy(A), v0=torch.from_numpy(v), deg=15, orth=orth)
		ja, jb = pt.lanczos(A, v0=v, deg=15, orth=orth)
		assert a.shape == ja.shape and b.shape == jb.shape
		_close(a, ja, 1e-12)
		_close(b, jb, 1e-12)
	T = lanczos(torch.from_numpy(A), v0=torch.from_numpy(v0), deg=15, orth=orth, sparse_mat=True)
	_close(T, pt.lanczos(A, v0=v0, deg=15, orth=orth, sparse_mat=True), 1e-12)


@pytest.mark.parametrize("ncv", [None, 6])
@pytest.mark.parametrize("orth", [0, 4])
def test_returned_basis_matches_jax(ncv, orth):
	"""The basis in natural order: with ``ncv < deg`` the last ncv vectors, unrolled
	from the ring buffer's slots; orth 0 on a DIA operator takes the whole-step path."""
	L = _path_laplacian(300)
	rng = np.random.default_rng(2)
	op = DIAOperator.from_scipy(L, device="cpu")
	for v in (rng.normal(size=300), rng.normal(size=(300, 3))):
		(a, b), Q = lanczos(op, v0=torch.from_numpy(v), deg=12, orth=orth, ncv=ncv, return_basis=True)
		(ja, jb), jQ = pt.lanczos(JaxDIA.from_scipy(L), v0=v, deg=12, orth=orth, ncv=ncv, return_basis=True)
		assert Q.shape == jQ.shape
		_close(a, ja, 1e-12)
		_close(Q, jQ, 1e-10)
	(_, _), Q = lanczos(op, v0=torch.from_numpy(rng.normal(size=300)), deg=12, orth=12, return_basis=True)
	_close(Q.T @ Q, np.eye(12), 1e-12)


def test_lanczos_seeded_start_and_breakdown_basis():
	A = sps.diags([np.arange(1.0, 7.0)], [0]).tocsr()  # the Krylov space is exhausted after 6 steps
	(a, b), Q = lanczos(A, v0=torch.ones(6, dtype=torch.float64), deg=6, orth=6, return_basis=True, device="cpu")
	(ja, jb), jQ = pt.lanczos(A, v0=np.ones(6), deg=6, orth=6, return_basis=True)
	_close(a, ja, 1e-12)
	_close(Q, jQ, 1e-10)
	x, y = lanczos(torch.from_numpy(_spd(40)[0]), deg=10, seed=3), lanczos(torch.from_numpy(_spd(40)[0]), deg=10, seed=3)
	assert torch.equal(x[0], y[0])
	assert not torch.equal(x[0], lanczos(torch.from_numpy(_spd(40)[0]), deg=10, seed=4)[0])


@pytest.mark.parametrize("method", ["auto", "tqli"])
def test_rayleigh_ritz_matches_jax(method):
	A, ew = _spd(60, seed=5)
	v0 = np.random.default_rng(6).normal(size=60)
	rw = rayleigh_ritz(torch.from_numpy(A), deg=60, orth=-1, v0=torch.from_numpy(v0), method=method)
	jrw = pt.rayleigh_ritz(A, deg=60, orth=-1, v0=v0, method=method)
	_close(np.sort(rw.numpy()), np.sort(np.asarray(jrw)), 1e-10)
	_close(np.sort(rw.numpy()), np.sort(ew), 1e-10)
	rw, Y, Q = rayleigh_ritz(torch.from_numpy(A), deg=10, v0=torch.from_numpy(v0), return_eigenvectors=True, return_basis=True)
	assert rw.shape == (10,) and Y.shape == (10, 10) and Q.shape == (60, 10)


@pytest.mark.parametrize("orth", [0, 3])
def test_coeffs_accumulate_like_jax(orth):
	"""The second pass of two-pass f(A)v: y = Σ c_t q_t, with a stacked (2, nv) coefficient set."""
	L = _path_laplacian(400)
	rng = np.random.default_rng(7)
	V0, C = rng.normal(size=(400, 5)), rng.normal(size=(10, 2, 5))
	got = lanczos_block_op(DIAOperator.from_scipy(L, device="cpu"), torch.from_numpy(V0), deg=10, ncv=max(orth, 2), orth=orth,
		return_basis=False, coeffs=torch.from_numpy(C))
	want = jax_lanczos_block_op(JaxDIA.from_scipy(L), jnp.asarray(V0), deg=10, ncv=max(orth, 2), orth=orth, return_basis=False,
		coeffs=jnp.asarray(C))
	assert got.y.shape == (2, 400, 5) and got.Q is None if orth == 0 else got.Q is not None
	_close(got.y, want.y, 1e-12)
	_close(got.alphas, want.alphas, 1e-12)


def test_bfloat16_basis_window_matches_jax():
	L = _path_laplacian(500)
	V0 = np.random.default_rng(8).normal(size=(500, 4))
	got = lanczos_block_op(DIAOperator.from_scipy(L, device="cpu"), torch.from_numpy(V0), deg=16, ncv=16, orth=16,
		basis_dtype=torch.bfloat16)
	want = jax_lanczos_block_op(JaxDIA.from_scipy(L), jnp.asarray(V0), deg=16, ncv=16, orth=16, basis_dtype=jnp.bfloat16)
	assert got.Q.dtype == torch.bfloat16
	_close(got.alphas, want.alphas, 1e-3)
	_close(got.betas, want.betas, 1e-3)
	_close(got.Q.float(), np.asarray(want.Q, dtype=np.float32), 1e-3)


def _strakos(n=100, lam1=0.1, lamn=100.0, rho=0.9):
	i = np.arange(1, n + 1)
	return lam1 + (i - 1) / (n - 1) * (lamn - lam1) * rho ** (n - i)


def test_selective_reorth_on_a_strakos_spectrum_matches_jax():
	"""Strakos' spectrum makes a sweep without re-orthogonalisation lose orthogonality
	fast (ghost Ritz values); selective re-orthogonalisation keeps the recovered
	spectrum, and its trigger trace and coefficients follow the JAX sweep."""
	ew = _strakos()
	n = ew.shape[0]
	A = np.diag(ew)
	V0 = np.random.default_rng(9).normal(size=(n, 2))
	got = lanczos_block_op(DenseOperator(torch.from_numpy(A)), torch.from_numpy(V0), deg=n, ncv=n, selective=True, return_basis=False)
	want = jax_lanczos_block_op(pt.operators.aslinop(A), jnp.asarray(V0), deg=n, ncv=n, selective=True, return_basis=False)
	trig, jtrig = got.reorth_steps.numpy(), np.asarray(want.reorth_steps)
	assert 0 < trig.sum() < n and np.array_equal(trig, jtrig)
	_close(got.alphas, want.alphas, 1e-8)
	_close(got.betas, want.betas, 1e-8)
	a, b = lanczos(torch.from_numpy(A), v0=torch.from_numpy(V0[:, 0]), deg=n, selective=True)
	ritz = np.sort(np.linalg.eigvalsh(np.diag(a.numpy()) + np.diag(b.numpy(), 1) + np.diag(b.numpy(), -1)))
	_close(ritz, np.sort(ew), 1e-8)
	a0, b0 = lanczos(torch.from_numpy(A), v0=torch.from_numpy(V0[:, 0]), deg=n, orth=0)
	ritz0 = np.linalg.eigvalsh(np.diag(a0.numpy()) + np.diag(b0.numpy(), 1) + np.diag(b0.numpy(), -1))
	assert np.sum(np.abs(ritz0 - ew.max()) < 1e-6) > 1  # without re-orthogonalisation: ghosts


def test_orthogonal_polynomial_basis_matches_jax():
	A, _ = _spd(50, seed=10)
	v0 = np.random.default_rng(11).normal(size=50)
	B = OrthogonalPolynomialBasis(torch.from_numpy(A), deg=8, v0=torch.from_numpy(v0))
	jB = pt.OrthogonalPolynomialBasis(A, deg=8, v0=v0)
	x = np.linspace(0.5, 3.0, 7)
	_close(B(torch.from_numpy(x)), jB(jnp.asarray(x)), 1e-9, 1e-10)
	_close(B.jacobi_matrix(), jB.jacobi_matrix(), 1e-12)
	for g, w in zip(B.gauss_quadrature(), jB.gauss_quadrature()):
		_close(g, w, 1e-10)
	trailing = OrthogonalPolynomialBasis(alphas=B.alphas, betas=torch.cat([B.betas[1:], torch.ones(1, dtype=torch.float64)]), betas_kind="trailing")
	_close(trailing.betas, B.betas, 0.0)


# --- MatrixFunction: f(A)v one- and two-pass, quadrature rules, stacked families ---------


@pytest.mark.parametrize("fun,orth", [("exp", 0), ("log", 0), ("inv", 4)])
@pytest.mark.parametrize("two_pass", [False, True])
def test_matrix_function_matvec_matches_jax(fun, orth, two_pass):
	L = _path_laplacian(600)
	X = np.random.default_rng(12).normal(size=(600, 6))
	kw = dict(deg=20, orth=orth, two_pass=two_pass, t=-0.5)
	M = MatrixFunction(DIAOperator.from_scipy(L, device="cpu"), fun, **kw)
	jM = pt.MatrixFunction(JaxDIA.from_scipy(L), fun, **kw)
	_close(M.matmat(torch.from_numpy(X)), jM.matmat(jnp.asarray(X)), 1e-10)
	_close(M.matvec(torch.from_numpy(X[:, 0])), jM.matvec(jnp.asarray(X[:, 0])), 1e-10)
	_close(M @ torch.from_numpy(X[:, 1]), jM @ jnp.asarray(X[:, 1]), 1e-10)


def test_matrix_function_against_the_dense_function():
	A, ew = _spd(70, seed=13)
	Q = np.linalg.eigh(A)[1]
	x = np.random.default_rng(14).normal(size=70)
	for fun, f in (("exp", np.exp), ("sqrt", np.sqrt), ("log", np.log)):
		want = Q @ (f(np.linalg.eigvalsh(A)) * (Q.T @ x))
		got = matrix_function(torch.from_numpy(A), fun, v=torch.from_numpy(x), deg=70, orth=-1)
		_close(got, want, 1e-8)
	M = MatrixFunction(torch.from_numpy(A), "exp", deg=70, orth=-1)
	M.fun = "log"
	_close(M.matvec(torch.from_numpy(x)), Q @ (np.log(np.linalg.eigvalsh(A)) * (Q.T @ x)), 1e-8)


def test_two_pass_auto_rules():
	op = DIAOperator.from_scipy(_path_laplacian(1000), device="cpu")
	assert not MatrixFunction(op, "exp")._use_two_pass(8)
	assert MatrixFunction(op, "exp", basis_dtype=torch.bfloat16)._use_two_pass(8)  # rule 1: a narrow window
	assert MatrixFunction(op, "exp", deg=20)._use_two_pass(2**30 // (20 * 1000 * 8) + 1)  # rule 2: past 1 GiB
	assert not MatrixFunction(op, "exp", two_pass=False, basis_dtype=torch.bfloat16)._use_two_pass(8)


@pytest.mark.parametrize("rule,interval", [("radau_lo", (0.5, 6.0)), ("radau_hi", (0.5, 6.0)), ("lobatto", (0.5, 6.0))])
def test_quad_rules_match_jax(rule, interval):
	L = _path_laplacian(500)
	X = np.random.default_rng(15).choice([-1.0, 1.0], size=(500, 8))
	kw = dict(deg=10, orth=0, quad_rule=rule, interval=interval)
	got = MatrixFunction(DIAOperator.from_scipy(L, device="cpu"), "log", **kw).quad(torch.from_numpy(X))
	want = pt.MatrixFunction(JaxDIA.from_scipy(L), "log", **kw).quad(jnp.asarray(X))
	_close(got, want, 0.0, 1e-10)
	gauss = MatrixFunction(DIAOperator.from_scipy(L, device="cpu"), "log", deg=10, orth=0).quad(torch.from_numpy(X))
	assert not torch.equal(got, gauss)


def test_stacked_quad_hutch_and_diag_match_jax():
	"""A stacked heat-kernel family from one sweep per batch, on injected probes."""
	L = _path_laplacian(400)
	fam, jfam = stacked("exp", -TAUS), pt.stacked("exp", -TAUS)
	assert stacked("exp", -TAUS) is fam and fam.nout == 5  # builtin families are memoised
	M = MatrixFunction(DIAOperator.from_scipy(L, device="cpu"), fam, deg=16, orth=0)
	jM = pt.MatrixFunction(JaxDIA.from_scipy(L), jfam, deg=16, orth=0)
	assert M.stack_shape == (5,)
	X = np.random.default_rng(16).choice([-1.0, 1.0], size=(400, 6))
	_close(M.quad(torch.from_numpy(X)), jM.quad(jnp.asarray(X)), 0.0, 1e-10)
	_close(M.matmat(torch.from_numpy(X)), jM.matmat(jnp.asarray(X)), 1e-10)
	kw = dict(batch=4, converge="count", count=12)
	got, res = hutch(M, pdf=_sampler(17), full=True, **kw)
	want = pt.hutch(jM, pdf=_sampler(17), **kw)
	assert got.shape == (5,) and res.nit == 12
	_close(got, want, 0.0, 1e-10)
	blocks = [_sampler(18)(size=(400, 3)) for _ in range(4)]
	stream = iter(blocks)
	jest = pt.diag(jM, pdf=lambda size: next(stream), converge="count", count=4, batch=3)
	est = run_diag(M, lambda it: torch.from_numpy(blocks[it]), CountCriterion(4), batch=3)
	assert est.shape == (5, 400)
	_close(est, jest, 1e-10)


def test_diag_of_a_stacked_family_and_its_exact_heat_kernel():
	n = 60
	L = _path_laplacian(n)
	M = MatrixFunction(DIAOperator.from_scipy(L, device="cpu"), stacked("exp", -TAUS[:2]), deg=30, orth=0)
	est = diag(M, batch=64, converge="count", count=8, seed=1)
	ew, U = np.linalg.eigh(L.toarray())
	for k, tau in enumerate(TAUS[:2]):
		exact = np.einsum("ij,j,ij->i", U, np.exp(-tau * ew), U)
		assert np.linalg.norm(est[k] - exact) / np.linalg.norm(exact) < 0.1


# --- criteria, record, callback, estimators -----------------------------------------------


def test_and_not_and_knee_criteria_match_jax():
	from primate_tpu.estimators import CountCriterion as JCount
	from primate_tpu.estimators import KneeCriterion as JKnee
	from primate_tpu.estimators import ToleranceCriterion as JTol

	A, _ = _spd(50, seed=19)
	for crit, jcrit in (
		(CountCriterion(40) & ToleranceCriterion(rtol=0.5), JCount(40) & JTol(rtol=0.5)),
		(~CountCriterion(8) | CountCriterion(24), ~JCount(8) | JCount(24)),
		(KneeCriterion(S=1.0), JKnee(S=1.0)),
		(KneeCriterion(S=1.0) | CountCriterion(64), JKnee(S=1.0) | JCount(64)),
	):
		got, res = hutch(torch.from_numpy(A), batch=4, pdf=_sampler(20), converge=crit, full=True)
		want, jres = pt.hutch(A, batch=4, pdf=_sampler(20), converge=jcrit, full=True)
		assert res.nit == jres.nit, (crit, res.nit, jres.nit)
		_close(got, want, 0.0, 1e-12)
	assert res.estimator.values is not None and len(res.estimator.values) == res.nit  # knee implies record
	_close(res.estimator.values, jres.estimator.values, 1e-12)


def test_record_and_callback_match_jax():
	A, _ = _spd(40, seed=21)
	seen, jseen = [], []
	got, res = hutch(torch.from_numpy(A), batch=5, pdf=_sampler(22), converge="count", count=20, record=True, full=True,
		callback=lambda r: seen.append((r.nit, r.estimate)))
	want, jres = pt.hutch(A, batch=5, pdf=_sampler(22), converge="count", count=20, record=True, full=True,
		callback=lambda r: jseen.append((r.nit, r.estimate)))
	assert [s[0] for s in seen] == [5, 10, 15, 20] == [s[0] for s in jseen]
	_close([s[1] for s in seen], [s[1] for s in jseen], 0.0, 1e-12)
	_close(res.estimator.values, jres.estimator.values, 1e-12)
	# diag: one callback per iteration, the running estimate each time
	calls, jcalls = [], []
	blocks = [_sampler(23)(size=(40, 2)) for _ in range(3)]
	stream = iter(blocks)
	pt.diag(A, pdf=lambda size: next(stream), converge="count", count=3, batch=2, callback=lambda r: jcalls.append(np.array(r.estimate)))
	est, dres = run_diag(DenseOperator(torch.from_numpy(A)), lambda it: torch.from_numpy(blocks[it]), CountCriterion(3), batch=2,
		full=True, callback=lambda r: calls.append(np.array(r.estimate)), record=True)
	assert len(calls) == len(jcalls) == 3
	_close(calls, jcalls, 1e-12)
	assert len(dres.estimator.values) == 3 * 40


def test_confidence_and_control_variable_estimators_match_jax():
	rng = np.random.default_rng(24)
	x = rng.normal(loc=3.0, size=40)
	est, jest = ConfidenceEstimator(0.9, device="cpu"), pt.estimators.ConfidenceEstimator(0.9)
	for chunk in np.split(x, 4):
		est.update(chunk)
		jest.update(chunk)
	_close(est.estimate, jest.estimate, 1e-12)
	_close(est.margin_of_error, jest.margin_of_error, 1e-12)
	_close(est.interval, jest.interval, 1e-12)
	cv = rng.normal(size=40)
	rows = np.stack([x + 0.8 * cv, cv], axis=1)
	est, jest = ControlVariableEstimator(ecv=0.0), pt.estimators.ControlVariableEstimator(ecv=0.0)
	for chunk in np.split(rows, 4):
		est.update(chunk)
		jest.update(chunk)
	_close(est.estimate, jest.estimate, 1e-10)
	_close(est.alpha, jest.alpha, 1e-10)
	_close(float(est.snapshot().var), float(jest.snapshot().var), 1e-10)
	fixed = ControlVariableEstimator(ecv=[0.0], alpha=[0.8])
	fixed.update(rows)
	_close(fixed.estimate, np.mean(x), 1e-12)


# --- random test matrices and samplers -----------------------------------------------------


def test_symmetric_and_haar_have_the_prescribed_spectrum():
	ew = np.linspace(-1.0, 2.0, 30)
	for A in (symmetric(30, ew=ew, seed=1, dtype=torch.float64, device="cpu"), haar(30, ew=ew, seed=1, dtype=torch.float64, device="cpu")):
		_close(A, A.T, 1e-14)
		_close(np.sort(np.linalg.eigvalsh(A.numpy())), ew, 1e-12)
	P = symmetric(40, pd=True, seed=2, dtype=torch.float64, device="cpu")
	assert np.linalg.eigvalsh(P.numpy()).min() >= -1e-12
	assert torch.equal(symmetric(10, seed=3, device="cpu"), symmetric(10, seed=3, device="cpu"))
	H = haar(25, ew=np.ones(25), seed=4, dtype=torch.float64, device="cpu")
	_close(H, np.eye(25), 1e-12)  # U Uᵀ = I: the basis is orthogonal
	_close(np.sort(np.linalg.eigvalsh(haar(8, ew=[3.0, 2.0], seed=5, dtype=torch.float64, device="cpu").numpy())), [0] * 6 + [2, 3], 1e-12)


def test_isotropic_streams_replay_one_batched_draw():
	a = Isotropic(pdf="normal", seed=6, dtype=torch.float64, device="cpu")
	cols = torch.stack([a((50,)) for _ in range(30)], dim=1)
	b = Isotropic(pdf="normal", seed=6, dtype=torch.float64, device="cpu")
	assert torch.equal(cols, b((50, 30)))
	c = Isotropic(pdf="normal", seed=6, dtype=torch.float64, device="cpu")
	assert torch.equal(torch.cat([c((50, 10)), c((50, 20))], dim=1), cols)
	V = isotropic((400, 2000), pdf="rademacher", seed=7, device="cpu")
	assert set(V.unique().tolist()) <= {-1.0, 1.0}
	C = (V @ V.T / 2000).numpy()
	assert abs(np.mean(np.diag(C)) - 1.0) < 1e-6 and np.abs(C - np.diag(np.diag(C))).max() < 0.2
	out = np.zeros((20, 3))
	assert isotropic(pdf="sphere", seed=8, out=out, device="cpu") is None
	_close(np.linalg.norm(out, axis=0), np.sqrt(20), 1e-12)
	assert isotropic(pdf="normal", seed=9, device="cpu")((5, 2)).shape == (5, 2)
	assert a(7).shape == (7, 1)  # an int size is one column, as in JAX
	assert a((4, 3, 2)).shape == (4, 3, 2)


# --- the keyword rule --------------------------------------------------------------------


def test_radau_request_is_not_the_gauss_rule_and_callbacks_run():
	"""The port once sent unported keywords of ``MatrixFunction`` to the builtin
	function, which dropped them: a Radau request returned the Gauss rule bit for
	bit, and ``hutch`` never called its callback. Both now behave as in JAX."""
	A, _ = _spd(50, seed=25, lo=1.0, hi=2.0)
	X = np.random.default_rng(26).choice([-1.0, 1.0], size=(50, 4))
	gauss = MatrixFunction(torch.from_numpy(A), "log", deg=4, orth=0).quad(torch.from_numpy(X))
	radau = MatrixFunction(torch.from_numpy(A), "log", deg=4, orth=0, quad_rule="radau_lo", interval=(0.5, 3.0)).quad(torch.from_numpy(X))
	assert float((radau - gauss).abs().min()) > 1e-9
	_close(radau, pt.MatrixFunction(A, "log", deg=4, orth=0, quad_rule="radau_lo", interval=(0.5, 3.0)).quad(X), 0.0, 1e-10)
	calls = []
	hutch(torch.from_numpy(A), batch=10, converge="count", count=30, seed=1, callback=calls.append)
	assert len(calls) == 3


PORTED_NOW = [
	("hutch", dict(differentiable=True)),
	("hutch", dict(grad_method="adjoint")),
	("hutch", dict(fprime=np.cos)),
	("hutch", dict(solver_rtol=1e-6)),
	("hutch", dict(solver_maxiter=10)),
	("diag", dict(differentiable=True)),
]


@pytest.mark.parametrize("entry,kwargs", PORTED_NOW, ids=[f"{e}-{next(iter(k))}" for e, k in PORTED_NOW])
def test_gradient_keywords_behave_as_in_jax(entry, kwargs):
	"""The keywords of the differentiable paths, once refused, now behave as in the JAX
	package on the same call: each runs there (the gradient keywords are dropped
	without ``differentiable=True``) and runs here, with a finite result of the shape
	JAX's has. The values are held to JAX's on injected probes in ``test_torch_autodiff.py``."""
	A = _spd(20, seed=27)[0]
	call = {
		"hutch": lambda f, M: f(M, converge="count", count=4, seed=1, **kwargs),
		"diag": lambda f, M: f(M, converge="count", count=2, seed=1, **kwargs),
	}[entry]
	want = call(getattr(pt, entry), A)
	got = call({"hutch": hutch, "diag": diag}[entry], torch.from_numpy(A))
	assert np.shape(np.asarray(got)) == np.shape(np.asarray(want))
	assert bool(np.all(np.isfinite(np.asarray(got.detach() if isinstance(got, torch.Tensor) else got))))
	if kwargs.get("differentiable"):
		assert isinstance(got, torch.Tensor)


# (entry, keywords, ported): True, or the error the call raises (an unported keyword raises
# NotImplementedError). A complex dtype raised until Hermitian operators were ported; it now
# runs, and on a real matrix lifted to complex128 gives the float64 call's result (the probes
# are drawn real). diag's resume raised until it was ported: a run of one iteration resumed to
# two gives the uninterrupted run's estimate. lanczos_block_op's phys raised until the padded
# carry was ported: phys=False is the flat sweep, and phys=True on a dense operator, which has
# no padded carry, raises ValueError (JAX warns and runs the flat sweep).
KEYWORD_CASES = [
	("diag", dict(resume="half"), True),
	("lanczos_block_op", dict(phys=True), ValueError),
	("lanczos_block_op", dict(phys=False), True),
	("MatrixFunction", dict(dtype=torch.complex128), True),
	("lanczos", dict(dtype=torch.complex128), True),
]


@pytest.mark.parametrize("entry,kwargs,ported", KEYWORD_CASES, ids=[f"{e}-{next(iter(k))}" for e, k, _ in KEYWORD_CASES])
def test_unported_keywords_raise(entry, kwargs, ported):
	A = torch.from_numpy(_spd(20, seed=27)[0])
	V0 = torch.ones((20, 2), dtype=torch.float64)
	X = torch.from_numpy(np.random.default_rng(27).choice([-1.0, 1.0], size=(20, 3)))
	if kwargs.get("resume") == "half":  # a run of 1 iteration, resumed to 2
		kwargs = dict(resume=diag(A, converge="count", count=1, seed=3, full=True)[1])
	call = {
		"hutch": lambda kw: hutch(A, converge="count", count=4, **kw),
		"diag": lambda kw: torch.from_numpy(diag(A, converge="count", count=2, seed=3, **kw)),
		"lanczos_block_op": lambda kw: torch.cat(lanczos_block_op(DenseOperator(A), V0, deg=4, ncv=2, **kw)[:2]),
		"MatrixFunction": lambda kw: MatrixFunction(A, "log", **kw).quad(X),
		"lanczos": lambda kw: torch.cat(lanczos(A, deg=4, seed=1, **kw)),
	}[entry]
	if ported is True:
		got, want = call(kwargs), call({})
		assert got.dtype == torch.float64  # α, β and quadratic forms of a Hermitian operator are real
		_close(got, want, 1e-12)
		return
	with pytest.raises(ported, match=next(iter(kwargs))):
		call(kwargs)


@pytest.mark.parametrize("entry", ["MatrixFunction", "hutch", "diag", "lanczos", "lanczos_block_op", "criterion"])
def test_unknown_keywords_raise_type_error(entry):
	A = torch.from_numpy(_spd(20, seed=28)[0])
	call = {
		"MatrixFunction": lambda: MatrixFunction(A, "log", orht=3),
		"hutch": lambda: hutch(A, converge="count", count=4, rtoll=1e-3),
		"diag": lambda: diag(A, converge="count", count=2, atoll=1.0),
		"lanczos": lambda: lanczos(A, deg=4, ncv_=3),
		"lanczos_block_op": lambda: lanczos_block_op(DenseOperator(A), torch.ones((20, 1), dtype=torch.float64), deg=4, ncv=2, orht=1),
		"criterion": lambda: hutch(A, converge=CountCriterion(4), count=8),
	}[entry]
	with pytest.raises(TypeError):
		call()
