"""Golub-Kahan bidiagonalisation, the Gram branches, block Krylov, ``lanczos_block``,
``Toeplitz`` and ``normalize_unit`` in the port against the JAX package, float64, on
numpy inputs made from a seed: injected start blocks give the same recurrences to
rounding (α, β and the block factors to 1e-12); the Gram quadrature and density take
the JAX package's probes. Counterparts of ``tests/test_bidiag.py`` and
``tests/test_block_krylov.py`` and of the Toeplitz / normalize_unit cases."""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import jax
import jax.numpy as jnp

import primate_tpu as pt
from primate_tpu import bidiag as jax_bidiag
from primate_tpu import block_krylov as jax_bk
from primate_tpu import density as jax_density
from primate_tpu.operators.sparse import DIAOperator as JaxDIA
from primate_tpu.operators.sparse import GramOperator as JaxGram
from primate_tpu.random import as_key
from primate_tpu.random import sample_isotropic as jax_sample

import primate_tpu_torch as ptt
from primate_tpu_torch import bidiag, block_krylov
from primate_tpu_torch import density as port_density
from primate_tpu_torch.operators.base import DenseOperator
from primate_tpu_torch.operators.sparse import GramOperator

torch.set_num_threads(1)


def _close(got, want, rtol=1e-12, atol=1e-12):
	got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
	np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


def _rect(m=60, n=36, seed=0, complex_=False):
	rng = np.random.default_rng(seed)
	X = rng.standard_normal((m, n)) @ np.diag(np.linspace(0.2, 3.0, n))
	if complex_:
		X = X + 1j * rng.standard_normal((m, n))
	return X


def _ops(X):
	return pt.operators.aslinop(jnp.asarray(X)), DenseOperator(torch.from_numpy(X))


@pytest.mark.parametrize("case", ["plain", "orth", "basis", "residual", "adjoint", "complex"])
def test_bidiag_core_on_an_injected_block(case):
	X = _rect(complex_=case == "complex")
	jop, top = _ops(X)
	adjoint = case == "adjoint"
	side = X.shape[0] if adjoint else X.shape[1]
	V0 = np.random.default_rng(1).standard_normal((side, 3))
	kw = dict(deg=12, orth={"orth": 4, "basis": 12}.get(case, 0), return_basis=case == "basis",
		return_residual=case == "residual", adjoint=adjoint)
	want = jax_bidiag.lanczos_bidiag_op(jop, jnp.asarray(V0, X.dtype), **kw)
	got = bidiag.lanczos_bidiag_op(top, torch.from_numpy(V0).to(top.dtype), **kw)
	_close(got.alphas, want.alphas, rtol=1e-10, atol=1e-12)
	_close(got.betas, want.betas, rtol=1e-10, atol=1e-12)
	if case == "basis":
		_close(got.U, want.U, rtol=1e-9, atol=1e-10)
		_close(got.V, want.V, rtol=1e-9, atol=1e-10)
	if case == "residual":
		_close(got.residual, want.residual, rtol=1e-10, atol=1e-12)


def test_bidiag_stops_on_rank_deficiency_as_jax_does():
	rng = np.random.default_rng(3)
	X = rng.standard_normal((40, 5)) @ rng.standard_normal((5, 30))  # rank 5
	jop, top = _ops(X)
	V0 = rng.standard_normal((30, 2))
	want = jax_bidiag.lanczos_bidiag_op(jop, jnp.asarray(V0), deg=10, orth=10, return_basis=True)
	got = bidiag.lanczos_bidiag_op(top, torch.from_numpy(V0), deg=10, orth=10, return_basis=True)
	_close(got.alphas, want.alphas, rtol=1e-8, atol=1e-10)
	_close(got.betas, want.betas, rtol=1e-8, atol=1e-10)
	assert np.all(got.alphas.numpy()[6:] == 0.0)


def test_lanczos_bidiag_full_degree_recovers_singular_values():
	X = _rect(40, 24, seed=4)
	out = ptt.lanczos_bidiag(torch.from_numpy(X), deg=24, orth=-1, seed=0)
	a, b = out.alphas[:, 0].numpy(), out.betas[:, 0].numpy()
	B = np.diag(a) + np.diag(b, 1)
	np.testing.assert_allclose(np.sort(np.linalg.svd(B, compute_uv=False)), np.sort(np.linalg.svd(X, compute_uv=False)), rtol=1e-8)
	d, e = bidiag.bidiag_jacobi(out.alphas, out.betas)
	wd, we = jax_bidiag.bidiag_jacobi(jnp.asarray(a[:, None]), jnp.asarray(b[:, None]))
	_close(d, wd)
	_close(e, we)


@pytest.mark.parametrize("transpose_first", [True, False])
@pytest.mark.parametrize("rule", ["gauss", "radau_lo"])
def test_gram_matrix_function_quad_matches_jax(transpose_first, rule):
	X = _rect(50, 30, seed=5)
	side = X.shape[1] if transpose_first else X.shape[0]
	V = np.random.default_rng(6).standard_normal((side, 4))
	kw = dict(deg=10, orth=3, quad_rule=rule, interval=(0.05, 1e3) if rule != "gauss" else None)
	jM = pt.MatrixFunction(JaxGram(jnp.asarray(X), transpose_first=transpose_first), "sqrt", **kw)
	tM = ptt.MatrixFunction(GramOperator(torch.from_numpy(X), transpose_first=transpose_first), "sqrt", **kw)
	_close(tM.quad(torch.from_numpy(V)), jM.quad(jnp.asarray(V)), rtol=1e-10, atol=1e-12)


def test_gram_hutch_and_matvec():
	"""hutch of the Gram identity is ‖X‖²_F in expectation; the Gram f(A)v is that of the formed X†X."""
	X = _rect(60, 20, seed=7)
	est = ptt.hutch(ptt.MatrixFunction(GramOperator(torch.from_numpy(X)), "identity", deg=20), batch=64,
		converge="count", count=64, seed=1)
	assert abs(est - np.sum(X**2)) < 0.05 * np.sum(X**2)
	v = np.random.default_rng(8).standard_normal(20)
	M = ptt.MatrixFunction(GramOperator(torch.from_numpy(X)), "identity", deg=20, orth=20)
	_close(M.matvec(torch.from_numpy(v)), X.T @ X @ v, rtol=1e-8, atol=1e-8)


def test_gram_spectral_density_matches_jax():
	X = _rect(48, 32, seed=9)
	jG, tG = JaxGram(jnp.asarray(X)), GramOperator(torch.from_numpy(X))
	want = jax_density.spectral_density(jG, grid=64, deg=12, nv=4, seed=3)
	# The port draws its own probes: hand it JAX's.
	V = np.asarray(jax_sample(as_key(3), (32, 4), pdf="rademacher", dtype=jnp.float64))
	import primate_tpu_torch.density as dens

	orig = dens.sample_isotropic
	dens.sample_isotropic = lambda g, shape, pdf, dtype: torch.tensor(V, dtype=dtype)
	try:
		got = port_density.spectral_density(tG, grid=64, deg=12, nv=4, seed=3)
	finally:
		dens.sample_isotropic = orig
	_close(got[0], want[0], rtol=1e-9, atol=1e-12)
	_close(got[1], want[1], rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("case", ["reorth", "no_reorth", "basis", "complex"])
def test_block_lanczos_core_on_an_injected_block(case):
	n, b = 40, 3
	if case == "complex":
		A = np.array(pt.hermitian(n, ew=np.linspace(0.5, 2.0, n), seed=2))
	else:
		A = np.array(pt.symmetric(n, ew=np.linspace(0.5, 2.0, n), seed=2))
	V0 = np.random.default_rng(3).standard_normal((n, b))
	kw = dict(deg=6, reorth=case != "no_reorth", return_basis=case == "basis")
	want = jax_bk._block_lanczos_core(pt.operators.aslinop(jnp.asarray(A)), jnp.asarray(V0), **kw)
	got = block_krylov._block_lanczos_core(DenseOperator(torch.from_numpy(A)), torch.from_numpy(V0), **kw)
	for g, w in zip(got[:3], want[:3]):
		_close(g, w, rtol=1e-10, atol=1e-12)
	if case == "basis":
		_close(got.basis, want.basis, rtol=1e-10, atol=1e-12)
	T = block_krylov.block_jacobi_dense(got.Ablocks, got.Bblocks)
	_close(T, jax_bk.block_jacobi_dense(want.Ablocks, want.Bblocks), rtol=1e-10, atol=1e-12)
	_close(block_krylov.block_quadrature(got, "exp", t=-0.5), jax_bk.block_quadrature(want, "exp", t=-0.5), rtol=1e-10, atol=1e-12)


def test_block_lanczos_exact_at_full_space_and_multiplicity():
	n, b = 24, 3
	ew = np.concatenate([np.full(3, 2.0), np.linspace(0.1, 1.0, n - 3)])  # triple top eigenvalue
	A = np.array(pt.symmetric(n, ew=ew, seed=4))
	out = ptt.block_lanczos(torch.from_numpy(A), b=b, deg=n // b, seed=0)
	theta = np.linalg.eigvalsh(block_krylov.block_jacobi_dense(out.Ablocks, out.Bblocks).numpy())
	np.testing.assert_allclose(np.sort(theta), np.sort(ew), atol=1e-8)
	V = np.random.default_rng(5).standard_normal((n, b))
	out = block_krylov._block_lanczos_core(DenseOperator(torch.from_numpy(A)), torch.from_numpy(V), deg=n // b)
	w, U = np.linalg.eigh(A)
	_close(block_krylov.block_quadrature(out, "log"), V.T @ (U * np.log(w)) @ U.T @ V, rtol=1e-8, atol=1e-8)


def test_block_slq_trace_matches_jax_on_its_blocks_and_converges():
	n, b, deg, nb = 30, 4, 5, 3
	ew = np.linspace(0.5, 2.0, n)
	A = np.array(pt.symmetric(n, ew=ew, seed=6))
	want = pt.block_slq_trace(jnp.asarray(A), "log", b=b, deg=deg, nblocks=nb, seed=11, full=True)
	keys = jax.random.split(as_key(11), nb)
	blocks = [torch.from_numpy(np.asarray(jax_sample(k, (n, b), pdf="normal", dtype=jnp.float64))) for k in keys]
	got = block_krylov.block_slq_samples(DenseOperator(torch.from_numpy(A)), blocks, ptt.special.param_callable("log"), deg)
	_close(got, want[1], rtol=1e-10, atol=1e-12)
	est, samples = ptt.block_slq_trace(torch.from_numpy(A), "log", b=8, deg=4, nblocks=32, seed=1, full=True)
	assert samples.shape == (32,) and abs(est - np.sum(np.log(ew))) < 4 * samples.std() / np.sqrt(32) + 1e-9
	# differentiable=True: a tensor with a gradient to the operator's entries. With f the
	# identity and deg·b = n each sample is tr(VᵀAV)/b, whose gradient VVᵀ/b gives tr(∇·A) = value.
	K = torch.from_numpy(A).requires_grad_(True)
	val = ptt.block_slq_trace(DenseOperator(K), None, b=n, deg=1, nblocks=1, seed=2, differentiable=True)
	val.backward()
	G = K.grad.numpy()
	_close(np.trace(G @ A), val.detach(), rtol=1e-9)
	_close(G, G.T, rtol=1e-9, atol=1e-12)


def test_lanczos_block_matches_jax():
	n = 50
	A = np.array(pt.symmetric(n, ew=np.linspace(0.1, 3.0, n), seed=8))
	V0 = np.random.default_rng(9).standard_normal((n, 3))
	want = pt.lanczos_block(lambda V: jnp.asarray(A) @ V, jnp.asarray(V0), deg=10, ncv=10, orth=10)
	At = torch.from_numpy(A)
	for mt in (None, lambda Vt: Vt @ At.T):
		got = ptt.lanczos_block(lambda V: At @ V, torch.from_numpy(V0), deg=10, ncv=10, orth=10, matmat_t=mt)
		_close(got.alphas, want.alphas, rtol=1e-12, atol=1e-12)
		_close(got.betas, want.betas, rtol=1e-12, atol=1e-12)
		_close(got.Q, want.Q, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("kind", ["symmetric", "general", "complex"])
def test_toeplitz_matches_jax_and_dense(kind):
	rng = np.random.default_rng(10)
	n = 37
	c = rng.standard_normal(n)
	r = None if kind == "symmetric" else rng.standard_normal(n)
	if kind == "complex":
		c = c + 1j * rng.standard_normal(n)
		r = np.concatenate([c[:1], rng.standard_normal(n - 1) + 1j * rng.standard_normal(n - 1)])
	if r is not None:
		r[0] = c[0]
	V = rng.standard_normal((n, 5))
	jT = pt.Toeplitz(jnp.asarray(c), None if r is None else jnp.asarray(r))
	tT = ptt.Toeplitz(c, r, device="cpu")
	want = np.asarray(jT.matmat(jnp.asarray(V, jT.dtype)))
	got = tT.matmat(torch.from_numpy(V).to(tT.dtype))
	assert got.dtype == (torch.complex128 if kind == "complex" else torch.float64)
	_close(got, want, rtol=1e-10, atol=1e-10)
	_close(tT.matmat_t(torch.from_numpy(V.T.copy()).to(tT.dtype)).T, want, rtol=1e-10, atol=1e-10)
	from scipy.linalg import toeplitz

	D = toeplitz(c, c if r is None else r)
	_close(tT.todense(), D, rtol=1e-12, atol=1e-12)


def test_toeplitz_is_the_path_laplacian():
	"""Toeplitz(c = [3, −1, 0, …]) is tridiag(−1, 3, −1): the same SLQ estimate as its DIA operator."""
	n = 64
	c = np.zeros(n)
	c[:2] = [3.0, -1.0]
	T = ptt.Toeplitz(torch.from_numpy(c))
	L = sps.diags([-np.ones(n - 1), 3.0 * np.ones(n), -np.ones(n - 1)], [-1, 0, 1]).tocsr()
	D = ptt.DIAOperator.from_scipy(L, dtype=torch.float64, device="cpu")
	V = torch.from_numpy(np.random.default_rng(12).standard_normal((n, 6)))
	_close(T.matmat(V), D.matmat(V), rtol=1e-12, atol=1e-12)
	est = [ptt.hutch(ptt.MatrixFunction(op, "log", deg=30, orth=-1), batch=16, converge="count", count=4, seed=0) for op in (T, D)]
	_close(est[0], est[1], rtol=1e-10)


def test_normalize_unit_matches_jax():
	n = 80
	L = sps.diags([-np.ones(n - 1), 3.0 * np.ones(n), -np.ones(n - 1)], [-1, 0, 1]).tocsr()
	op = ptt.DIAOperator.from_scipy(L, dtype=torch.float64, device="cpu")
	from primate_tpu.lanczos import rayleigh_ritz as jax_rr

	rw = np.asarray(jax_rr(JaxDIA.from_scipy(L, dtype=jnp.float64), deg=64, orth=-1, seed=0))
	alpha = 1.01 * np.max(np.abs(rw))
	S = ptt.normalize_unit(op, interval=(-1, 1), deg=64, seed=0)
	assert isinstance(S, ptt.operators.ScaledOperator)
	np.testing.assert_allclose(S.s, 1.0 / alpha, rtol=1e-4)  # the two sweeps start from different vectors
	ew = np.linalg.eigvalsh(S.todense().numpy())
	assert ew.min() >= -1.0 and ew.max() <= 1.0
	S2 = ptt.normalize_unit(op, interval=(0, 2), deg=64, seed=0)
	ew2 = np.linalg.eigvalsh(S2.todense().numpy())
	assert ew2.min() >= 0.0 and ew2.max() <= 2.0
	with pytest.raises(ValueError):
		ptt.normalize_unit(op, interval=(1, 0))
