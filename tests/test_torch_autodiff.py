"""The port's autograd against the JAX package's ``jax.grad``: the kernel Functions,
the differentiable spectral sums, ``differentiable=True`` on the estimators and the
GP log-likelihood, on the same numpy inputs and the same injected probes (float64).

Tolerances: values 1e-8 relative; gradients 1e-7 relative to their largest entry;
a kernel Function against autograd of its plain version 1e-12.
"""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import jax
import jax.numpy as jnp

import primate_tpu as pt
from primate_tpu import autodiff as jad
from primate_tpu.operators.sparse import DIAOperator as JaxDIA
from primate_tpu.random import as_key
from primate_tpu.random import sample_isotropic as jax_sample
from primate_tpu_torch import (
	COOOperator,
	CSROperator,
	DIAOperator,
	MatrixFunction,
	autodiff,
	diag,
	hutch,
	hutchpp,
	stacked,
	xdiag,
	xnystrace,
	xtrace,
)
from primate_tpu_torch.diagonal import diag_ratio, xdiag_core
from primate_tpu_torch.operators.base import DenseOperator
from primate_tpu_torch.ops import autograd as kad
from primate_tpu_torch.ops import bsr, dia
from primate_tpu_torch.solvers import nystrom_core, solve
from primate_tpu_torch.trace import hutchpp_core, xnystrace_core, xtrace_chain

torch.set_num_threads(1)
SEED = 5
VAL_RTOL, GRAD_RTOL = 1e-8, 1e-7


def _banded(n, offsets=(-4, -1, 0, 1, 4), seed=0, symmetric=True):
	rng = np.random.default_rng(seed)
	A = sps.diags([rng.uniform(-1, 1, n - abs(o)) for o in offsets], offsets, shape=(n, n))
	if symmetric:
		A = 0.5 * (A + A.T)
	return (A + sps.diags(np.abs(A).sum(axis=1).A.ravel() + 1.0)).todia()


def _spd(n, seed=0, lo=1.0, hi=3.0):
	rng = np.random.default_rng(seed)
	Q, _ = np.linalg.qr(rng.normal(size=(n, n)))
	return (Q * rng.uniform(lo, hi, n)) @ Q.T


def _rows_bands(A):
	"""Row-aligned bands of a scipy matrix (the port's convention, also the JAX package's)."""
	op = DIAOperator.from_scipy(A, device="cpu")
	return op.bands.numpy(), op.offsets


def _probes(key, shape, pdf="rademacher"):
	return np.array(jax_sample(key, shape, pdf=pdf, dtype=jnp.float64))


def _close(got, want, rtol):
	got, want = np.asarray(got, dtype=float), np.asarray(want, dtype=float)
	assert np.max(np.abs(got - want)) <= rtol * max(np.max(np.abs(want)), 1e-300), (got, want)


# --- the kernel Functions ---------------------------------------------------------------


def _grads(fn, *inputs, G):
	out = fn(*inputs)
	return out, torch.autograd.grad(out, inputs, G)


@pytest.mark.parametrize("layout", ["probe_major", "node_major"])
@pytest.mark.parametrize("offsets", [(-1, 0, 1), (-7, -2, 0, 3, 9, 40)])
def test_dia_functions_match_autograd_of_the_plain_version(layout, offsets):
	"""Non-symmetric bands, offsets past the short n's middle: the Function's backward
	(adjoint bands, band reduction) against autograd through the plain version; the
	band gradient is exactly 0 in each band's unused tail."""
	rng = np.random.default_rng(len(offsets))
	n, k = 37, 5
	bands = torch.tensor(rng.normal(size=(len(offsets), n)), requires_grad=True)
	offs = torch.tensor(offsets)
	shape = (k, n) if layout == "probe_major" else (n, k)
	x = torch.tensor(rng.normal(size=shape), requires_grad=True)
	G = torch.tensor(rng.normal(size=shape))
	ad, ref = (kad.dia_stencil_t_ad, dia.dia_stencil_t_ref) if layout == "probe_major" else (kad.dia_stencil_ad, dia.dia_stencil_ref)
	out, (gb, gx) = _grads(lambda b, v: ad(b, v, offs, offsets), bands, x, G=G)
	assert type(out.grad_fn).__name__ == "_DIAStencilBackward"
	want, (wb, wx) = _grads(lambda b, v: ref(b, offs, v), bands, x, G=G)
	torch.testing.assert_close(out, want, rtol=0, atol=1e-12)
	torch.testing.assert_close(gx, wx, rtol=0, atol=1e-12)
	torch.testing.assert_close(gb, wb, rtol=0, atol=1e-12)
	for d, off in enumerate(offsets):
		tail = slice(n - off, n) if off > 0 else slice(0, -off)
		assert bool(torch.all(gb[d, tail] == 0))


def test_dia_operator_gradient_in_a_transposed_view_keeps_its_layout():
	A = _banded(40, symmetric=False)
	bands, offsets = _rows_bands(A)
	op = DIAOperator(torch.tensor(bands, requires_grad=True), offsets, A.shape)
	V = torch.tensor(np.random.default_rng(1).normal(size=(6, 40))).T.requires_grad_(True)  # probe-major view
	(gV,) = torch.autograd.grad(op.matmat(V).sum(), V)
	assert gV.stride() == V.stride()
	np.testing.assert_allclose(gV.numpy(), A.T @ np.ones((40, 6)), rtol=0, atol=1e-12)


@pytest.mark.parametrize("tile", [(4, 4), (8, 16)])
def test_bsr_function_matches_autograd_of_the_plain_version(tile):
	"""A misaligned block structure: n not a multiple of the tile, an empty block row."""
	bm, bn = tile
	rng = np.random.default_rng(bm)
	n = 53
	M = sps.random(n, n, density=0.08, random_state=rng).toarray()
	M[bm : 2 * bm] = 0.0
	S = sps.csr_matrix(M)
	S.resize((-(-n // bm) * bm, -(-n // bn) * bn))
	S = S.tobsr(blocksize=tile)
	blocks = torch.tensor(S.data, requires_grad=True)
	indptr, indices = torch.tensor(S.indptr), torch.tensor(S.indices)
	V = torch.tensor(rng.normal(size=(n, 3)), requires_grad=True)
	G = torch.tensor(rng.normal(size=(n, 3)))
	out, (gb, gV) = _grads(lambda b, v: kad.bsr_spmm_ad(b, v, indptr, indices, n), blocks, V, G=G)
	assert type(out.grad_fn).__name__ == "_BSRSpMMBackward"
	want, (wb, wV) = _grads(lambda b, v: bsr.bsr_spmm_ref(b, indptr, indices, v, n), blocks, V, G=G)
	for got, ref in ((out, want), (gb, wb), (gV, wV)):
		torch.testing.assert_close(got, ref, rtol=0, atol=1e-12)


@pytest.mark.parametrize("kind", ["csr", "coo"])
def test_sparse_value_gradients_match_dense_autograd(kind):
	"""``grad_data[j] = Σ_b G[row_j, b]·V[col_j, b]`` and the input gradient through the
	transposed matrix, against autograd of the dense product; COO with repeated coordinates."""
	rng = np.random.default_rng(3)
	n = 30
	A = sps.random(n, n, density=0.2, random_state=rng, format="coo")
	if kind == "coo":
		row, col, data = np.r_[A.row, A.row[:5]], np.r_[A.col, A.col[:5]], np.r_[A.data, A.data[:5]]
		values = torch.tensor(data, requires_grad=True)
		op = COOOperator(values, row, col, (n, n))
	else:
		A = A.tocsr()
		row, col = np.repeat(np.arange(n), np.diff(A.indptr)), A.indices
		values = torch.tensor(A.data, requires_grad=True)
		op = CSROperator(values, A.indices, A.indptr, (n, n))
	V = torch.tensor(rng.normal(size=(n, 4)), requires_grad=True)
	out = op.matmat(V)
	assert kind == "coo" or type(out.grad_fn).__name__ == "_CSRSpMMBackward"
	G = torch.tensor(rng.normal(size=(n, 4)))
	gd, gV = torch.autograd.grad(out, (values, V), G)
	dense = torch.zeros((n, n), dtype=torch.float64).index_put((torch.tensor(row), torch.tensor(col)), values, accumulate=True)
	wd, wV = torch.autograd.grad(dense @ V, (values, V), G)
	torch.testing.assert_close(gd, wd, rtol=0, atol=1e-12)
	torch.testing.assert_close(gV, wV, rtol=0, atol=1e-12)


def test_the_lanczos_recurrence_refuses_reverse_mode():
	"""Reverse mode through the Lanczos recurrence refuses a complex (Hermitian) operator, as JAX's
	gradients are real-symmetric only; a real operator's sweep differentiates (held to ``jax.grad``
	in ``test_torch_lanczos_grad.py``), and under ``torch.no_grad()`` takes the in-place sweep."""
	bands, offsets = _rows_bands(_banded(30))
	op = DIAOperator(torch.tensor(bands, requires_grad=True), offsets, (30, 30))
	X = torch.ones((30, 2), dtype=torch.float64)
	cop = DIAOperator(torch.tensor(bands, dtype=torch.complex128, requires_grad=True), offsets, (30, 30))
	with pytest.raises(NotImplementedError, match="Lanczos recurrence is real only"):
		MatrixFunction(cop, "log", deg=5, orth=0).quad(X.to(torch.complex128))
	q = MatrixFunction(op, "log", deg=5, orth=0).quad(X)
	assert q.requires_grad and bool(torch.all(torch.isfinite(torch.autograd.grad(q.sum(), op.bands)[0])))
	with torch.no_grad():
		torch.testing.assert_close(MatrixFunction(op, "log", deg=5, orth=0).quad(X), q.detach(), rtol=1e-12, atol=0)


# --- spectral sums on injected probes ----------------------------------------------------

CASES = [("log", "auto", None), ("log", "slq", None), ("inv", "auto", None), ("sqrt", "auto", None), ("log", "auto", "fprime")]


def _operators(kind, n=48):
	"""(numpy matrix, port operator with a differentiable tensor, that tensor, JAX operator of a jnp leaf)."""
	if kind == "dense":
		A = _spd(n, seed=2)
		t = torch.tensor(A, requires_grad=True)
		return A, DenseOperator(t), t, lambda leaf: leaf, A
	A = _banded(n, seed=4)
	if kind == "dia":
		bands, offsets = _rows_bands(A)
		t = torch.tensor(bands, requires_grad=True)
		return A.toarray(), DIAOperator(t, offsets, A.shape), t, lambda leaf: JaxDIA(leaf, offsets, A.shape), bands
	C = A.tocsr()
	t = torch.tensor(C.data, requires_grad=True)
	return C.toarray(), CSROperator(t, C.indices, C.indptr, C.shape), t, lambda leaf: leaf, C.toarray()


@pytest.mark.parametrize("fun,method,fprime", CASES, ids=["-".join(str(c) for c in case) for case in CASES])
@pytest.mark.parametrize("kind", ["dense", "dia", "csr"])
def test_spectral_sum_matches_jax_on_injected_probes(kind, fun, method, fprime):
	"""Value and gradient of the port's Function against JAX's custom_vjp on the same probes.
	CSR: the value gradient against JAX's dense gradient at the stored entries."""
	A, op, t, jax_op, leaf = _operators(kind)
	Z = _probes(as_key(SEED), (A.shape[0], 16))
	deg, orth = 10, (0 if kind == "dia" else 10)
	fp_t = torch.reciprocal if fprime else None
	M = MatrixFunction(op, fun, deg=deg, orth=orth)
	got = autodiff.spectral_sum_core(M, lambda i: torch.from_numpy(Z), fprime=fp_t, grad_method=method, solver_rtol=1e-11)
	(g,) = torch.autograd.grad(got, t)
	core = jad._spectral_sum_core(jnp.reciprocal if fprime else None, method, 1e-11, None)

	def jax_est(x):
		return core(pt.MatrixFunction(jax_op(x), fun, deg=deg, orth=orth), jnp.asarray(Z))

	want, jg = jax.value_and_grad(jax_est)(jnp.asarray(leaf))
	_close(got.detach(), want, VAL_RTOL)
	jg = np.asarray(jg)
	if kind == "csr":
		C = sps.csr_matrix(A)
		jg = jg[np.repeat(np.arange(A.shape[0]), np.diff(C.indptr)), C.indices]
	_close(g, jg, GRAD_RTOL)


@pytest.mark.parametrize("entry", ["logdet", "trace_inv"])
def test_logdet_and_trace_inv_match_jax_chunked(entry):
	"""The chunked path: chunk ``i``'s probes are JAX's ``fold_in(key, i)`` block, injected."""
	A, op, t, jax_op, leaf = _operators("dia")
	n, chunk, nchunks = A.shape[0], 8, 3
	key = as_key(SEED)
	fun = "log" if entry == "logdet" else "inv"
	M = MatrixFunction(op, fun, deg=12, orth=0)
	draw = lambda i: torch.from_numpy(_probes(jax.random.fold_in(key, i), (n, chunk)))  # noqa: E731
	got = autodiff.spectral_sum_core(M, draw, nchunks, solver_rtol=1e-11)
	(g,) = torch.autograd.grad(got, t)
	core = jad._spectral_sum_chunked_core(None, "auto", 1e-11, None, "rademacher", nchunks, chunk)
	want, jg = jax.value_and_grad(lambda x: core(pt.MatrixFunction(jax_op(x), fun, deg=12, orth=0), jax.random.key_data(key)))(
		jnp.asarray(leaf)
	)
	_close(got.detach(), want, VAL_RTOL)
	_close(g, jg, GRAD_RTOL)
	# The entry point draws its own probes: finite, with a gradient, and near the exact value.
	ew = np.linalg.eigvalsh(A)
	est = getattr(autodiff, entry)(op, deg=12, orth=0, nv=64, chunk=16, seed=1, device="cpu")
	exact = np.sum(np.log(ew)) if entry == "logdet" else np.sum(1 / ew)
	assert abs(float(est) - exact) / abs(exact) < 0.05
	(g2,) = torch.autograd.grad(est, t)
	assert torch.isfinite(g2).all()


def test_spectral_sum_errors_as_in_jax():
	A, op, t, _, _ = _operators("dense", n=20)
	Z = torch.from_numpy(_probes(as_key(1), (20, 4)))
	fam = autodiff.spectral_sum_core(MatrixFunction(op, stacked("exp", [-0.5, -1.0]), deg=6, orth=6), lambda i: Z)
	assert fam.shape == (2,)
	with pytest.raises(NotImplementedError, match="stacked"):
		fam.sum().backward()
	est = autodiff.spectral_sum_core(MatrixFunction(op, "exp", deg=6, orth=6), lambda i: Z, grad_method="cg")
	with pytest.raises(ValueError, match="grad_method='cg'"):
		est.backward()


# --- the estimators' differentiable paths -----------------------------------------------


def _fold_in_stream(seed, n, pdf):
	key = as_key(seed)
	return lambda it, k: torch.from_numpy(_probes(jax.random.fold_in(key, it), (n, k), pdf))


def test_hutch_differentiable_equals_the_count_path_and_differentiates():
	A, op, t, _, _ = _operators("dia")
	M = MatrixFunction(op, "log", deg=12, orth=0)
	with torch.no_grad():
		fwd = hutch(M, batch=8, converge="count", count=24, seed=3)
	est = hutch(M, batch=8, converge="count", count=24, seed=3, differentiable=True, solver_rtol=1e-10)
	assert est.shape == () and abs(float(est) - fwd) <= 1e-12 * abs(fwd)
	(g,) = torch.autograd.grad(est, t)
	assert torch.isfinite(g).all()
	# The plain trace: d tr(A) / d band_0 = 1, exactly, through the mean of quadratic forms.
	plain = hutch(op, batch=8, converge="count", count=16, seed=3, differentiable=True)
	with torch.no_grad():
		assert abs(float(plain) - hutch(op, batch=8, converge="count", count=16, seed=3)) <= 1e-12 * abs(float(plain))
	(gp,) = torch.autograd.grad(plain, t)
	main = list(op.offsets).index(0)
	assert float(gp[main].mean()) == pytest.approx(1.0, abs=0.5)
	with pytest.raises(ValueError):
		hutch(M, converge="confidence", differentiable=True)
	with pytest.raises(ValueError):
		hutch(M, converge="count", count=8, full=True, differentiable=True)


def test_diag_differentiable_matches_jax():
	A, op, t, jax_op, leaf = _operators("dia")
	n, batch, count = A.shape[0], 4, 6
	stream = _fold_in_stream(SEED, n, "rademacher")
	got = diag_ratio(op, lambda i: stream(i, batch), count)
	w = np.random.default_rng(0).normal(size=n)
	(g,) = torch.autograd.grad(got @ torch.from_numpy(w), t)

	def jax_diag(x):
		return pt.diag(jax_op(x), converge="count", count=count, seed=SEED, batch=batch, differentiable=True)

	want = jax_diag(jnp.asarray(leaf))
	jg = jax.grad(lambda x: jax_diag(x) @ jnp.asarray(w))(jnp.asarray(leaf))
	_close(got.detach(), want, VAL_RTOL)
	_close(g, jg, GRAD_RTOL)
	d = diag(op, batch=batch, converge="count", count=count, seed=1, differentiable=True)
	assert isinstance(d, torch.Tensor) and d.requires_grad and d.shape == (n,)


def test_sketch_estimators_differentiate_as_jax():
	"""hutchpp, xnystrace, xtrace and xdiag: value and gradient of the fixed programs on
	the JAX package's probes, against ``jax.grad`` through the JAX estimators."""
	A, op, t, jax_op, leaf = _operators("dense", n=40)
	n, w = A.shape[0], np.random.default_rng(1).normal(size=A.shape[0])
	k1, k2 = jax.random.split(as_key(SEED))
	nb = 9
	cases = {
		"hutchpp": (
			lambda: hutchpp_core(op, torch.from_numpy(_probes(k1, (n, nb))), torch.from_numpy(_probes(k2, (n, nb))))[0],
			lambda x: pt.hutchpp(jax_op(x), m=nb, seed=SEED, differentiable=True),
		),
		"xnystrace": (
			lambda: torch.mean(xnystrace_core(op, torch.from_numpy(_probes(as_key(SEED), (n, 12), "normal")))),
			lambda x: pt.xnystrace(jax_op(x), m=12, seed=SEED, differentiable=True),
		),
		"xtrace": (
			lambda: xtrace_chain(op, _fold_in_stream(SEED, n, "sphere"), 8, 24, True),
			lambda x: pt.xtrace(jax_op(x), batch=8, converge="count", count=24, seed=SEED, differentiable=True),
		),
		"xdiag": (
			lambda: xdiag_core(op, torch.from_numpy(_probes(as_key(SEED), (n, 10), "sphere"))) @ torch.from_numpy(w),
			lambda x: pt.xdiag(jax_op(x), m=20, seed=SEED, differentiable=True) @ jnp.asarray(w),
		),
	}
	for name, (port, ref) in cases.items():
		got = port()
		(g,) = torch.autograd.grad(got, t)
		want, jg = jax.value_and_grad(ref)(jnp.asarray(leaf))
		_close(got.detach(), want, VAL_RTOL)
		_close(g, jg, GRAD_RTOL)
	# The entry points return tensors that carry the gradient.
	for est in (hutchpp(op, m=9, seed=1, differentiable=True), xnystrace(op, m=12, seed=1, differentiable=True),
			xtrace(op, batch=8, converge="count", count=16, seed=1, differentiable=True),
			xdiag(op, m=20, seed=1, differentiable=True).sum()):
		assert isinstance(est, torch.Tensor) and est.requires_grad


# --- the GP log-likelihood -----------------------------------------------------------------


def test_gp_nll_and_gradient_match_jax_value_and_grad():
	"""``examples/gp_log_likelihood.py``'s loss at n = 256: RBF kernel plus noise, SLQ logdet
	(deg 24, orth 8, 32 probes) and a Nyström-preconditioned solve, with the JAX package's
	probes and Nyström test block injected; value and θ gradient."""
	n, d, nv = 256, 2, 32
	rng = np.random.default_rng(0)
	X = rng.uniform(-2, 2, (n, d))
	y = np.sin(X.sum(axis=1)) + 0.1 * rng.normal(size=n)
	theta0 = np.array([0.1, -1.0])
	key = as_key(SEED)
	Z = _probes(key, (n, nv))
	Om = np.array(jax_sample(as_key(0), (n, 48), pdf="normal", dtype=jnp.float64))

	def jax_kernel(theta):
		ell, noise = jnp.exp(theta)
		sq = jnp.sum((jnp.asarray(X)[:, None, :] - jnp.asarray(X)[None, :, :]) ** 2, axis=-1)
		return jnp.exp(-0.5 * sq / ell**2) + (noise + 1e-4) * jnp.eye(n)

	def jax_nll(theta):
		K = jax_kernel(theta)
		logdet = jad._spectral_sum_core(None, "auto", 1e-6, None)(pt.MatrixFunction(K, "log", deg=24, orth=8), jnp.asarray(Z))
		pre = pt.nystrom_precond(jax.lax.stop_gradient(K), rank=48, seed=0)
		return 0.5 * (logdet + jnp.asarray(y) @ pt.solve(K, jnp.asarray(y), rtol=1e-8, precond=pre) + n * jnp.log(2 * jnp.pi))

	want, jg = jax.value_and_grad(jax_nll)(jnp.asarray(theta0))
	theta = torch.tensor(theta0, requires_grad=True)
	ell, noise = torch.exp(theta)
	Xt = torch.from_numpy(X)
	K = torch.exp(-0.5 * torch.sum((Xt[:, None, :] - Xt[None, :, :]) ** 2, dim=-1) / ell**2) + (noise + 1e-4) * torch.eye(n, dtype=torch.float64)
	op = DenseOperator(K)
	logdet = autodiff.spectral_sum_core(MatrixFunction(op, "log", deg=24, orth=8), lambda i: torch.from_numpy(Z))
	pre = nystrom_core(DenseOperator(K.detach()), torch.from_numpy(Om))
	yt = torch.from_numpy(y)
	nll = 0.5 * (logdet + yt @ solve(op, yt, rtol=1e-8, precond=pre) + n * np.log(2 * np.pi))
	nll.backward()
	_close(nll.detach(), want, VAL_RTOL)
	_close(theta.grad, jg, 1e-6)


def test_gp_nll_on_a_dia_operator_meets_its_closed_form():
	"""``K(θ) = e^{θ₀}·T + e^{θ₁}·I`` (T the 1-D Dirichlet Laplacian) as a DIA operator whose
	bands are computed from θ: NLL and both gradient components within 1% of the closed
	forms through T's DST-I eigenbasis (the card's phase 13 at n = 2,000)."""
	import scipy.fft

	n = 2000
	theta = torch.zeros(2, dtype=torch.float64, requires_grad=True)
	a, b = torch.exp(theta)
	one = torch.ones(n, dtype=torch.float64)
	lo, hi = one.clone(), one.clone()
	lo[0], hi[-1] = 0.0, 0.0
	K = DIAOperator(torch.stack([-a * lo, (2 * a + b) * one, -a * hi]), (-1, 0, 1), (n, n))
	y = torch.from_numpy(np.random.default_rng(13).normal(size=n))
	nll = 0.5 * (autodiff.logdet(K, deg=20, orth=0, nv=128, chunk=64, seed=13, solver_rtol=1e-5) + y @ solve(K, y, rtol=1e-5)
		+ n * np.log(2 * np.pi))
	nll.backward()
	lam = 2 - 2 * np.cos(np.arange(1, n + 1) * np.pi / (n + 1))
	yh = scipy.fft.dst(y.numpy(), type=1, norm="ortho")
	exact = 0.5 * (np.sum(np.log(lam + 1)) + np.sum(yh**2 / (lam + 1)) + n * np.log(2 * np.pi))
	g0 = 0.5 * (np.sum(lam / (lam + 1)) - np.sum(lam * yh**2 / (lam + 1) ** 2))
	g1 = 0.5 * (np.sum(1 / (lam + 1)) - np.sum(yh**2 / (lam + 1) ** 2))
	assert abs(float(nll) - exact) / abs(exact) < 0.01
	np.testing.assert_allclose(theta.grad.numpy(), [g0, g1], rtol=0.01)
