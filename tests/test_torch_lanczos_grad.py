"""Reverse mode through the Lanczos recurrence: the port's autograd against ``jax.grad``.

``MatrixFunction.matmat`` (one pass and two, ``orth`` 0 and 5), ``lanczos()``'s (α, β) and
``diag(MatrixFunction, differentiable=True)`` (on the JAX package's ``fold_in`` probes) are
differentiated with respect to DIA bands, BSR tiles, a dense matrix and the scale and shift of
``AffineOperator``/``ScaledOperator``, on the same numpy inputs in both packages. The GKL sweep
(``lanczos_bidiag``) is held to ``jax.grad`` as well, with and without re-orthogonalisation.

Tolerances, relative to the largest entry of the JAX gradient: 1e-8 in float64, where the two
sides differ only in the order of their sums and in LAPACK's eigenvectors; 2e-4 in float32
(rounding amplified through ``deg`` steps and the eigenvector derivatives). The spectra are
separated, so the Ritz values and ``eigh``'s 1/(λᵢ − λⱼ) terms stay well conditioned.
"""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import jax
import jax.numpy as jnp

import primate_tpu as pt
from primate_tpu.operators.base import AffineOperator as JaxAffine
from primate_tpu.operators.sparse import BSROperator as JaxBSR
from primate_tpu.operators.sparse import DIAOperator as JaxDIA
from primate_tpu.random import as_key
from primate_tpu.random import sample_isotropic as jax_sample

import primate_tpu_torch as ptt
from primate_tpu_torch import BSROperator, DIAOperator, MatrixFunction
from primate_tpu_torch.diagonal import diag_ratio
from primate_tpu_torch.lanczos import lanczos_block_op
from primate_tpu_torch.operators.base import AffineOperator, DenseOperator, ScaledOperator

torch.set_num_threads(1)
N, NV, DEG, SEED = 48, 3, 10, 11
GRAD_RTOL = {np.float64: 1e-8, np.float32: 2e-4}


def _banded(n=N, seed=0):
	"""A symmetric banded matrix, diagonally dominant (eigenvalues in about [1, 6])."""
	rng = np.random.default_rng(seed)
	offs = (-6, -1, 1, 6)
	A = sps.diags([rng.uniform(-1, 1, n - abs(o)) for o in offs], offs, shape=(n, n))
	A = 0.5 * (A + A.T)
	return (A + sps.diags(np.abs(A).sum(axis=1).A.ravel() + 1.0)).todia()


def _rows_bands(A):
	"""Row-aligned bands ``band[k][i] = A[i, i + off_k]`` of a scipy DIA matrix."""
	n = A.shape[0]
	D = A.toarray()
	offsets = tuple(int(o) for o in sorted(A.offsets))
	bands = np.zeros((len(offsets), n))
	for k, off in enumerate(offsets):
		i = np.arange(max(0, -off), min(n, n - off))
		bands[k, i] = D[i, i + off]
	return bands, offsets


def _operators(kind, dtype=np.float64):
	"""``(leaf, port operator of a tensor leaf, JAX operator of a jnp leaf)`` for one symmetric matrix."""
	A = _banded()
	if kind == "dia":
		bands, offsets = _rows_bands(A)
		return bands.astype(dtype), lambda t: DIAOperator(t, offsets, A.shape), lambda x: JaxDIA(x, offsets, A.shape)
	if kind == "bsr":
		S = sps.csr_matrix(A).tobsr(blocksize=(4, 4))
		S.sort_indices()
		ind, ptr = S.indices, S.indptr
		return (
			S.data.astype(dtype),
			lambda t: BSROperator(t, ind, ptr, A.shape),
			lambda x: JaxBSR(x, ind, ptr, A.shape),
		)
	return A.toarray().astype(dtype), DenseOperator, lambda x: x


def _grads(kind, f_port, f_jax, dtype=np.float64):
	leaf, port_op, jax_op = _operators(kind, dtype)
	t = torch.tensor(leaf, requires_grad=True)
	val = f_port(port_op(t))
	(g,) = torch.autograd.grad(val, t)
	jval, jg = jax.value_and_grad(lambda x: f_jax(jax_op(x)))(jnp.asarray(leaf))
	return val.detach(), g.numpy(), np.asarray(jval), np.asarray(jg)


def _close_grad(g, jg, dtype=np.float64):
	assert np.all(np.isfinite(g))
	assert np.max(np.abs(g - jg)) <= GRAD_RTOL[dtype] * np.max(np.abs(jg))


def _VW(dtype=np.float64):
	rng = np.random.default_rng(SEED)
	return rng.normal(size=(N, NV)).astype(dtype), rng.normal(size=(N, NV)).astype(dtype)


@pytest.mark.parametrize("two_pass", [False, True])
@pytest.mark.parametrize("orth", [0, 5])
@pytest.mark.parametrize("kind", ["dia", "bsr", "dense"])
def test_matrix_function_matmat_grad_matches_jax(kind, orth, two_pass):
	"""``Σ W∘f(A)V`` for f = log, one pass (stored basis) and two (coefficients, then a second sweep)."""
	V, W = _VW()

	def f_port(op):
		return torch.sum(torch.from_numpy(W) * MatrixFunction(op, "log", deg=DEG, orth=orth, two_pass=two_pass).matmat(torch.from_numpy(V)))

	def f_jax(op):
		return jnp.sum(jnp.asarray(W) * pt.MatrixFunction(op, "log", deg=DEG, orth=orth, two_pass=two_pass).matmat(jnp.asarray(V)))

	val, g, jval, jg = _grads(kind, f_port, f_jax)
	np.testing.assert_allclose(float(val), float(jval), rtol=1e-10)
	_close_grad(g, jg)


@pytest.mark.parametrize("kind", ["dia", "bsr"])
def test_matrix_function_matmat_grad_float32(kind):
	"""The same in float32 (TF32 never enters: the sweep has no matmul, the coefficients run under
	``full_f32_matmul``), against ``jax.grad`` in float32."""
	V, W = _VW(np.float32)

	def f_port(op):
		return torch.sum(torch.from_numpy(W) * MatrixFunction(op, "exp", t=-0.5, deg=DEG, orth=0).matmat(torch.from_numpy(V)))

	def f_jax(op):
		return jnp.sum(jnp.asarray(W) * pt.MatrixFunction(op, "exp", t=-0.5, deg=DEG, orth=0).matmat(jnp.asarray(V)))

	val, g, jval, jg = _grads(kind, f_port, f_jax, np.float32)
	assert g.dtype == np.float32
	np.testing.assert_allclose(float(val), float(jval), rtol=1e-5)
	_close_grad(g, jg, np.float32)


@pytest.mark.parametrize("orth", [0, 3, -1])
@pytest.mark.parametrize("kind", ["dia", "bsr", "dense"])
def test_lanczos_coefficients_grad_matches_jax(kind, orth):
	"""A weighted sum of ``lanczos()``'s α and β over a block of start vectors."""
	V, _ = _VW()
	rng = np.random.default_rng(SEED + 1)
	wa, wb = rng.normal(size=(DEG, NV)), rng.normal(size=(DEG - 1, NV))

	def f_port(op):
		a, b = ptt.lanczos(op, torch.from_numpy(V), deg=DEG, orth=orth)
		return torch.sum(torch.from_numpy(wa) * a) + torch.sum(torch.from_numpy(wb) * b)

	def f_jax(op):
		a, b = pt.lanczos(op, jnp.asarray(V), deg=DEG, orth=orth)
		return jnp.sum(jnp.asarray(wa) * a) + jnp.sum(jnp.asarray(wb) * b)

	_, g, _, jg = _grads(kind, f_port, f_jax)
	_close_grad(g, jg)


@pytest.mark.parametrize("kind", ["dia", "bsr", "dense"])
def test_diag_of_a_matrix_function_differentiates_as_jax(kind):
	"""``diag(MatrixFunction(A, "log"), differentiable=True)`` on JAX's ``fold_in`` probes, and the
	public call on the port's own probes (a tensor with a gradient)."""
	batch, count = 4, 3
	key = as_key(SEED)
	blocks = [torch.from_numpy(np.array(jax_sample(jax.random.fold_in(key, i), (N, batch), pdf="rademacher", dtype=jnp.float64)))
		for i in range(count)]
	w = np.random.default_rng(SEED + 2).normal(size=N)

	def f_port(op):
		return diag_ratio(MatrixFunction(op, "log", deg=DEG, orth=0), lambda i: blocks[i], count) @ torch.from_numpy(w)

	def f_jax(op):
		d = pt.diag(pt.MatrixFunction(op, "log", deg=DEG, orth=0), converge="count", count=count, batch=batch, seed=SEED,
			differentiable=True)
		return d @ jnp.asarray(w)

	_, g, _, jg = _grads(kind, f_port, f_jax)
	_close_grad(g, jg)
	leaf, port_op, _ = _operators(kind)
	t = torch.tensor(leaf, requires_grad=True)
	d = ptt.diag(MatrixFunction(port_op(t), "log", deg=DEG, orth=0), converge="count", count=2, batch=batch, seed=1,
		differentiable=True)
	assert d.requires_grad and d.shape == (N,)
	(gd,) = torch.autograd.grad(d.sum(), t)
	assert bool(torch.all(torch.isfinite(gd)))


@pytest.mark.parametrize("node", ["affine", "scaled"])
def test_scale_and_shift_gradients_match_jax(node):
	"""The shift ``t`` of ``A + t·I`` and the scale ``s`` of ``s·(A + t·I)`` as leaves, through a
	one-pass ``MatrixFunction.matmat`` of a DIA operator."""
	A = _banded()
	bands, offsets = _rows_bands(A)
	V, W = _VW()
	base = DIAOperator(torch.from_numpy(bands), offsets, A.shape)
	jbase = JaxDIA(jnp.asarray(bands), offsets, A.shape)

	def port(p):
		op = AffineOperator(base, t=p[0]) if node == "affine" else ScaledOperator(base, t=p[0], s=p[1])
		return torch.sum(torch.from_numpy(W) * MatrixFunction(op, "log", deg=DEG, orth=0).matmat(torch.from_numpy(V)))

	def jax_f(p):
		op = JaxAffine(jbase, t=p[0]) if node == "affine" else (jbase + p[0]) * p[1]
		return jnp.sum(jnp.asarray(W) * pt.MatrixFunction(op, "log", deg=DEG, orth=0).matmat(jnp.asarray(V)))

	p0 = np.array([0.3, 1.7])
	p = torch.tensor(p0, requires_grad=True)
	(g,) = torch.autograd.grad(port(p), p)
	jg = np.asarray(jax.grad(jax_f)(jnp.asarray(p0)))
	_close_grad(g.numpy(), jg)


def test_no_grad_sweeps_are_unchanged():
	"""A sweep under ``torch.no_grad()`` takes the in-place path whether or not the operator's
	tensor requires a gradient, bit for bit; the out-of-place path gives the same numbers to
	rounding, and only it carries a gradient."""
	A = _banded()
	bands, offsets = _rows_bands(A)
	V0 = torch.from_numpy(_VW()[0])
	t = torch.tensor(bands, requires_grad=True)
	plain = DIAOperator(torch.tensor(bands), offsets, A.shape)
	for kw in (dict(orth=0), dict(orth=5), dict(orth=0, return_basis=True), dict(selective=True)):
		ncv = DEG if kw.get("return_basis") or kw.get("selective") else 5
		want = lanczos_block_op(plain, V0, deg=DEG, ncv=ncv, **kw)
		with torch.no_grad():
			got = lanczos_block_op(DIAOperator(t, offsets, A.shape), V0, deg=DEG, ncv=ncv, **kw)
		ad = lanczos_block_op(DIAOperator(t, offsets, A.shape), V0, deg=DEG, ncv=ncv, **kw)
		assert not got.alphas.requires_grad and ad.alphas.requires_grad
		for x, y, z in zip(got, want, ad):
			if x is not None:
				assert torch.equal(x, y)
				np.testing.assert_allclose(z.detach().numpy(), y.numpy(), rtol=0, atol=1e-12)


def test_complex_operators_refuse_reverse_mode():
	H = torch.tensor(np.array(pt.hermitian(12, ew=np.linspace(0.5, 1.5, 12), seed=1)), requires_grad=True)
	with pytest.raises(NotImplementedError, match="real only"):
		MatrixFunction(DenseOperator(H), "log", deg=4, orth=0).quad(torch.ones((12, 2), dtype=torch.complex128))


@pytest.mark.parametrize("basis", [False, True])
@pytest.mark.parametrize("orth", [0, 3, -1])
def test_gkl_sweep_grad_matches_jax(orth, basis):
	"""``lanczos_bidiag`` of a dense rectangular matrix: its α, β (and a basis vector) against
	``jax.grad``. With ``orth > 0`` the windows are replaced slot by slot, never written in place."""
	rng = np.random.default_rng(SEED + 3)
	X, V0, w = rng.normal(size=(40, 24)), rng.normal(size=(24, 3)), rng.normal(size=(6, 3))

	def value(out, lib, arr):
		r = lib.sum(arr(w) * out.alphas) + lib.sum(arr(w[:5]) * out.betas)
		return r + lib.sum(out.U[2] ** 3) if basis else r

	t = torch.tensor(X, requires_grad=True)
	out = ptt.lanczos_bidiag(t, V0=torch.from_numpy(V0), deg=6, orth=orth, return_basis=basis, device="cpu")
	(g,) = torch.autograd.grad(value(out, torch, torch.from_numpy), t)
	jg = jax.grad(lambda x: value(pt.lanczos_bidiag(x, V0=jnp.asarray(V0), deg=6, orth=orth, return_basis=basis), jnp,
		jnp.asarray))(jnp.asarray(X))
	_close_grad(g.numpy(), np.asarray(jg))
