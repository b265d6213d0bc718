"""Property-based invariants of the port (hypothesis; ``tests/test_property.py``), on the CPU.

The structural invariants every estimator relies on, over random sparsity patterns, shapes and
spectra: the formats against scipy on all four apply paths, the operator algebra against dense
arithmetic, Lanczos exact at full degree, the Gauss rules' weights, XTrace exact at full budget, the
spectral-sum gradient identity, and the CSR apply with hub rows against scipy (the port's counterpart
of the JAX package's sliced-ELL layout). One more holds ``spectral_quad_form``'s Daleckii–Krein
gradient to ``jax.grad`` on Jacobi matrices with zeroed couplings and repeated blocks, where Ritz
values meet. The two sharded properties are in ``tests/test_torch_parallel.py``.

Every test runs derandomized with at most 15 examples, so the same cases run every time.
"""

import numpy as np
import scipy.sparse as sps
import torch
from hypothesis import given, settings, strategies as st

import primate_tpu_torch as ptt
from primate_tpu_torch.integrate import spectral_quad_form
from primate_tpu_torch.operators import aslinop
from primate_tpu_torch.operators.sparse import BSROperator, COOOperator, CSROperator, DIAOperator

torch.set_num_threads(1)
DEV = "cpu"
SETTINGS = settings(max_examples=15, deadline=None, derandomize=True, database=None)


def _np(x):
	return torch.as_tensor(x).detach().cpu().numpy()


def _t(x):
	return torch.from_numpy(np.ascontiguousarray(x))


def _rand_sparse(n: int, density_milli: int, seed: int, banded: bool) -> sps.csr_matrix:
	rng = np.random.default_rng(seed)
	if banded:
		offs = sorted({0, *rng.integers(-min(5, n - 1), min(5, n - 1) + 1, size=3).tolist()})
		A = sps.diags([rng.normal(size=n - abs(o)) for o in offs], offs, shape=(n, n))
	else:
		A = sps.random(n, n, density=max(density_milli, 1) / 1000.0, random_state=int(seed) % 2**31)
	A = (A + A.T).tocsr()
	A.setdiag(A.diagonal() + 1.0)  # a stored diagonal (the DIA main band exists)
	return A.tocsr()


@SETTINGS
@given(n=st.integers(6, 40), density=st.integers(5, 300), seed=st.integers(0, 10_000), banded=st.booleans())
def test_formats_agree_with_scipy(n, density, seed, banded):
	"""``from_scipy`` → ``todense`` is scipy's dense matrix, and the four apply paths agree with it, for
	every sparse format, over random patterns (near-empty and dense-ish)."""
	A = _rand_sparse(n, density, seed, banded)
	Ad = A.toarray()
	V = np.random.default_rng(seed + 1).normal(size=(n, 3))
	v = V[:, 0]
	ops = [
		CSROperator.from_scipy(A, device=DEV),
		COOOperator.from_scipy(A.tocoo(), device=DEV),
		DIAOperator.from_scipy(A.todia(), device=DEV),
		BSROperator.from_scipy(A, blocksize=(2, 2), device=DEV) if n % 2 == 0 else None,
	]
	for op in ops:
		if op is None:
			continue
		name = type(op).__name__
		assert np.allclose(_np(op.todense()), Ad, atol=1e-10), name
		assert np.allclose(_np(op.matvec(_t(v))), Ad @ v, atol=1e-8), name
		assert np.allclose(_np(op.matmat(_t(V))), Ad @ V, atol=1e-8), name
		assert np.allclose(_np(op.matmat_t(_t(V.T))), (Ad @ V).T, atol=1e-8), name
		assert np.allclose(_np(op.rmatvec(_t(v))), Ad.T @ v, atol=1e-8), name


@SETTINGS
@given(
	n=st.integers(4, 24),
	seed=st.integers(0, 10_000),
	c=st.floats(-3, 3, allow_nan=False),
	s=st.floats(-3, 3, allow_nan=False).filter(lambda x: abs(x) > 1e-3),
)
def test_operator_algebra_matches_dense(n, seed, c, s):
	"""``(s·A + c·I) ∘ B`` and the rest of the operator algebra equal dense arithmetic."""
	rng = np.random.default_rng(seed)
	A = rng.normal(size=(n, n))
	A = (A + A.T) / 2
	B = rng.normal(size=(n, n))
	B = (B + B.T) / 2
	x = rng.normal(size=n)
	opA, opB, xt = aslinop(_t(A)), aslinop(_t(B)), _t(x)
	assert np.allclose(_np((opA + c) @ xt), A @ x + c * x, atol=1e-8)
	assert np.allclose(_np((s * opA) @ xt), s * (A @ x), atol=1e-8)
	assert np.allclose(_np((opA - opB) @ xt), (A - B) @ x, atol=1e-8)
	assert np.allclose(_np((c - opA) @ xt), c * x - A @ x, atol=1e-8)
	assert np.allclose(_np((opA @ opB) @ xt), A @ (B @ x), atol=1e-7)
	assert np.allclose(_np((opA / s) @ xt), (A @ x) / s, atol=1e-8)
	assert np.allclose(_np(opA.T @ xt), A.T @ x, atol=1e-8)


@SETTINGS
@given(n=st.integers(4, 20), seed=st.integers(0, 10_000))
def test_lanczos_full_degree_exactness(n, seed):
	"""At deg = n with full re-orthogonalisation the Ritz values are the eigenvalues and the basis
	is orthonormal."""
	ew = np.sort(np.random.default_rng(seed).uniform(0.1, 5.0, n))
	if np.min(np.diff(ew)) < 1e-3:  # separated spectra only (clustered ones lose copies)
		ew = ew + np.arange(n) * 2e-3
	A = ptt.symmetric(n, ew=ew, seed=seed, dtype=torch.float64, device=DEV)
	(a, b), Q = ptt.lanczos(A, deg=n, orth=-1, return_basis=True, seed=seed + 1)
	rw = np.sort(_np(ptt.eigvalsh_tridiag(a, b)))
	assert np.allclose(rw, ew, atol=1e-6)
	Qn = _np(Q)
	Qn = Qn[:, :, 0] if Qn.ndim == 3 else Qn
	G = Qn.T @ Qn if Qn.shape[0] == n else Qn @ Qn.T
	assert np.allclose(G, np.eye(n), atol=1e-6)


@SETTINGS
@given(deg=st.integers(2, 16), seed=st.integers(0, 10_000))
def test_quadrature_rule_properties(deg, seed):
	"""Golub-Welsch weights of a random Jacobi matrix are ≥ 0 and sum to 1; FTTR reproduces them at
	full degree."""
	rng = np.random.default_rng(seed)
	d, e = _t(rng.uniform(1.0, 3.0, deg)), _t(rng.uniform(0.2, 0.8, deg - 1))
	nodes, weights = (_np(x) for x in ptt.quadrature(d, e, quad="gw"))
	assert np.all(weights >= -1e-12)
	assert abs(weights.sum() - 1.0) < 1e-8
	nf, wf = (_np(x) for x in ptt.quadrature(d, e, quad="fttr"))
	order = np.argsort(nodes)
	assert np.allclose(np.sort(nf), nodes[order], atol=1e-8)
	assert np.allclose(wf[np.argsort(nf)], weights[order], atol=1e-6)


@SETTINGS
@given(n=st.integers(8, 32), seed=st.integers(0, 10_000))
def test_xtrace_exact_at_full_budget_random(n, seed):
	"""XTrace's m = n exactness is an algebraic identity: it holds for any symmetric matrix."""
	A = np.random.default_rng(seed).normal(size=(n, n))
	A = (A + A.T) / 2
	est = ptt.xtrace(_t(A), batch=max(2, n // 3), seed=seed)
	assert abs(float(est) - np.trace(A)) < 1e-4 * max(1.0, abs(np.trace(A)))


@SETTINGS
@given(n=st.integers(8, 24), seed=st.integers(0, 10_000), fun=st.sampled_from(["log", "inv", "exp"]))
def test_spectral_sum_gradient_identity_random(n, seed, fun):
	"""For SPD A and a builtin f, ``d/ds E[tr f((1+s)A)]`` at 0 is ``tr(f'(A)·A)``, exact from the
	eigendecomposition; 8n probes keep the estimator's noise below the limit. Covers the CG
	(log, inv) and the SLQ (exp) backward."""
	ew = np.random.default_rng(seed).uniform(0.5, 2.0, n)
	A = ptt.symmetric(n, pd=True, ew=ew, seed=seed, dtype=torch.float64, device=DEV)
	s = torch.zeros((), dtype=torch.float64, requires_grad=True)
	val = ptt.spectral_sum((1.0 + s) * A, fun=fun, deg=n, orth=-1, nv=8 * n, seed=seed + 1, solver_rtol=1e-12)
	(g,) = torch.autograd.grad(val, s)
	fp = {"log": lambda x: 1.0 / x, "inv": lambda x: -1.0 / x**2, "exp": np.exp}[fun]
	want = float(np.sum(fp(ew) * ew))
	assert np.isclose(float(g), want, rtol=0.15), (fun, float(g), want)


@SETTINGS
@given(n=st.integers(8, 120), seed=st.integers(0, 10_000), hubs=st.integers(0, 4), k=st.sampled_from([1, 3, 17, 33, 64]))
def test_csr_hub_rows_match_scipy(n, seed, hubs, k):
	"""The CSR apply is exact for any row-length distribution: random patterns with up to 4 dense
	hub rows, at probe widths across the JAX layout's padding boundaries."""
	rng = np.random.default_rng(seed)
	A = sps.random(n, n, density=0.05, random_state=int(seed) % 2**31, format="lil")
	for _ in range(hubs):
		A[int(rng.integers(0, n)), :] = rng.normal(size=n)
	A = (A + A.T).tocsr()
	A.setdiag(A.diagonal() + 1.0)
	A = A.tocsr()
	op = CSROperator.from_scipy(A, device=DEV)
	V = rng.normal(size=(n, k))
	assert np.allclose(_np(op.matmat(_t(V))), A @ V, atol=1e-10)
	assert np.allclose(_np(op.matmat_t(_t(V.T))), (A @ V).T, atol=1e-10)
	assert np.allclose(_np(op.matvec(_t(V[:, 0]))), A @ V[:, 0], atol=1e-10)


@SETTINGS
@given(
	block=st.integers(1, 4),
	copies=st.integers(2, 3),
	seed=st.integers(0, 10_000),
	fun=st.sampled_from(["exp", "log", "square"]),
)
def test_quad_form_gradient_at_degenerate_jacobi_matrices(block, copies, seed, fun):
	"""``spectral_quad_form``'s gradient equals ``jax.grad`` of the JAX package's ``custom_jvp`` on
	Jacobi matrices whose couplings are zero between 2 or 3 equal blocks (Ritz values meet), padded
	with zero nodes to 12 (a deflated probe's), 3 in a batch, within 1e-12 of the largest entry. The
	shape is fixed so that JAX compiles once for each ``fun``."""
	import jax
	import jax.numpy as jnp

	from primate_tpu.integrate import spectral_quad_form as jax_quad_form

	k, batch = 12, 3
	rng = np.random.default_rng(seed)
	d0, e0 = rng.uniform(1.0, 3.0, (batch, block)), rng.uniform(0.2, 0.8, (batch, block - 1))
	d = np.concatenate([np.tile(d0, copies), np.zeros((batch, k - block * copies))], axis=-1)
	e = np.zeros((batch, k - 1))
	for c in range(copies):
		e[:, c * block : c * block + block - 1] = e0
	fj, ft = {
		"exp": (jnp.exp, torch.exp),
		"log": (lambda x: jnp.log(jnp.maximum(x, 1e-300)), lambda x: torch.log(torch.clamp(x, min=1e-300))),
		"square": (lambda x: x**2, lambda x: x**2),
	}[fun]
	gj = jax.grad(lambda a, b: jnp.sum(jax_quad_form(a, b, fj)), argnums=(0, 1))(jnp.asarray(d), jnp.asarray(e))
	D, E = _t(d).requires_grad_(True), _t(e).requires_grad_(True)
	spectral_quad_form(D, E, ft).sum().backward()
	for got, want in ((D.grad, gj[0]), (E.grad, gj[1])):
		want = np.asarray(want)
		assert np.all(np.isfinite(_np(got)))
		assert np.abs(_np(got) - want).max() <= 1e-12 * max(np.abs(want).max(), 1.0)
