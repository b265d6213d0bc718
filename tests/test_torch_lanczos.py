"""The port's Lanczos sweep, tridiagonal quadrature, Welford state and
MatrixFunction.quad against the JAX package, on the same numpy inputs (f64)."""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import jax.numpy as jnp

import primate_tpu as pt
from primate_tpu.integrate import spectral_quad_form as jax_spectral_quad_form
from primate_tpu.lanczos import lanczos_block_op as jax_lanczos_block_op
from primate_tpu.operators.sparse import DIAOperator as JaxDIA
from primate_tpu.stats import cov_update as jax_cov_update
from primate_tpu.stats import make_cov_state as jax_make_cov_state
from primate_tpu.tridiag import eigh_tridiag as jax_eigh_tridiag
from primate_tpu_torch import DIAOperator, MatrixFunction, cov_state_from_numpy, eigh_tridiag, lanczos_block_op
from primate_tpu_torch.estimators import MeanEstimator
from primate_tpu_torch.integrate import spectral_quad_form
from primate_tpu_torch.special import param_callable
from primate_tpu_torch.stats import cov_matrix, cov_update, make_cov_state

torch.set_num_threads(1)


def _path_laplacian(n):
	return sps.diags([-np.ones(n - 1), 3.0 * np.ones(n), -np.ones(n - 1)], [-1, 0, 1]).tocsr()


@pytest.mark.parametrize("orth", [0, 5])
def test_lanczos_block_op_matches_jax_phys_and_flat(orth):
	"""The port's sweep (plain fused step on the CPU) against JAX's halo-padded
	carry through the Pallas phys kernel (interpret mode) and its flat XLA sweep."""
	n, nv, deg = 3000, 16, 20
	L = _path_laplacian(n)
	V0 = np.random.default_rng(0).normal(size=(n, nv))
	ncv = max(orth, 2)
	got = lanczos_block_op(DIAOperator.from_scipy(L, device="cpu"), torch.from_numpy(V0), deg=deg, ncv=ncv, orth=orth)
	assert got.alphas.shape == (deg, nv) and got.betas.shape == (deg, nv)
	jop = JaxDIA.from_scipy(L)
	for phys in (True, False):
		want = jax_lanczos_block_op(jop, jnp.asarray(V0), deg=deg, ncv=ncv, orth=orth, return_basis=False, phys=phys)
		np.testing.assert_allclose(got.alphas.numpy(), np.asarray(want.alphas), rtol=0, atol=1e-8)
		np.testing.assert_allclose(got.betas.numpy(), np.asarray(want.betas), rtol=0, atol=1e-8)


def test_lanczos_breakdown_emits_zeros_like_jax():
	"""A Krylov space exhausted before deg: the done flags and the guarded divide
	make α/β exactly zero afterwards, as in the JAX sweep."""
	n = 6
	A = sps.diags([np.arange(1.0, n + 1)], [0]).tocsr()  # diagonal: exhausts after n steps
	V0 = np.random.default_rng(1).normal(size=(n, 3))
	got = lanczos_block_op(DIAOperator.from_scipy(A, device="cpu"), torch.from_numpy(V0), deg=n, ncv=n, orth=n)
	want = jax_lanczos_block_op(JaxDIA.from_scipy(A), jnp.asarray(V0), deg=n, ncv=n, orth=n, return_basis=False)
	np.testing.assert_allclose(got.alphas.numpy(), np.asarray(want.alphas), rtol=0, atol=1e-8)
	np.testing.assert_allclose(got.betas.numpy(), np.asarray(want.betas), rtol=0, atol=1e-8)
	assert np.all(got.betas.numpy()[-1] < 1e-6)


@pytest.mark.parametrize("phys", [True, False])
def test_whole_step_plain_version_matches_jax_core(phys):
	"""orth = 0: every step is the whole-step plain version (residuals carried with
	their guarded divisors), held to JAX's ``_lanczos_core`` at f64 round-off."""
	n, nv, deg = 3000, 16, 20
	L = _path_laplacian(n)
	V0 = np.random.default_rng(0).normal(size=(n, nv))
	got = lanczos_block_op(DIAOperator.from_scipy(L, device="cpu"), torch.from_numpy(V0), deg=deg, ncv=2, orth=0)
	want = jax_lanczos_block_op(JaxDIA.from_scipy(L), jnp.asarray(V0), deg=deg, ncv=2, orth=0, return_basis=False, phys=phys)
	np.testing.assert_allclose(got.alphas.numpy(), np.asarray(want.alphas), rtol=0, atol=1e-12)
	np.testing.assert_allclose(got.betas.numpy(), np.asarray(want.betas), rtol=0, atol=1e-12)


def test_bfloat16_sweep_rounds_each_basis_vector_like_jax():
	"""orth = 0 on a bfloat16 operator: q_next is rounded to bfloat16 every step, as
	in JAX's flat sweep. Carrying the residuals in float32 instead drifts from it by
	about 4e-3 in α here; the bfloat16 stencils' own rounding accounts for ~2e-4."""
	n, nv, deg = 500, 8, 10
	L = _path_laplacian(n)
	V0 = np.random.default_rng(0).normal(size=(n, nv))
	got = lanczos_block_op(
		DIAOperator.from_scipy(L, dtype=torch.bfloat16, device="cpu"), torch.from_numpy(V0).to(torch.bfloat16),
		deg=deg, ncv=2, orth=0,
	)
	want = jax_lanczos_block_op(
		JaxDIA.from_scipy(L, dtype=jnp.bfloat16), jnp.asarray(V0, dtype=jnp.bfloat16), deg=deg, ncv=2, orth=0,
		return_basis=False, phys=False,
	)
	assert got.alphas.dtype == torch.float32
	np.testing.assert_allclose(got.alphas.numpy(), np.asarray(want.alphas, dtype=np.float32), rtol=0, atol=1e-3)
	np.testing.assert_allclose(got.betas.numpy(), np.asarray(want.betas, dtype=np.float32), rtol=0, atol=1e-3)


def _split_operator(n=50):
	"""A tridiagonal DIA operator whose first three rows form an invariant subspace."""
	off = -0.5 * np.ones(n - 1)
	off[2] = 0.0
	return sps.diags([off, np.linspace(1.0, 4.0, n), off], [-1, 0, 1]).tocsr()


def test_whole_step_breakdown_zeroes_like_jax():
	"""Probe 0 lies in a 3-dimensional invariant subspace, so β₃ ≈ 0 mid-sweep:
	afterwards its α and β are exactly zero, as the JAX package makes them; the
	other probes run on."""
	A = _split_operator()
	V0 = np.random.default_rng(1).normal(size=(A.shape[0], 4))
	V0[3:, 0] = 0.0
	got = lanczos_block_op(DIAOperator.from_scipy(A, device="cpu"), torch.from_numpy(V0), deg=8, ncv=2, orth=0)
	want = jax_lanczos_block_op(JaxDIA.from_scipy(A), jnp.asarray(V0), deg=8, ncv=2, orth=0, return_basis=False)
	a, b = got.alphas.numpy(), got.betas.numpy()
	assert b[2, 0] < 1e-12 and np.all(b[:2, 0] > 0.1)
	assert np.all(a[3:, 0] == 0.0) and np.all(b[3:, 0] == 0.0)
	assert np.all(np.asarray(want.alphas)[3:, 0] == 0.0) and np.all(np.asarray(want.betas)[3:, 0] == 0.0)
	assert np.all(b[:, 1:] > 0.01)
	np.testing.assert_allclose(a, np.asarray(want.alphas), rtol=0, atol=1e-12)
	np.testing.assert_allclose(b, np.asarray(want.betas), rtol=0, atol=1e-12)


def test_dia_whole_step_equals_the_generic_step():
	"""The DIA operator's whole step (the plain version of the two step kernels on
	the CPU) against the generic step of the same matrix as a dense operator."""
	from primate_tpu_torch.operators.base import DenseOperator
	from primate_tpu_torch.ops.dia import lanczos_state

	A = _split_operator(40)
	rng = np.random.default_rng(5)
	v_cur, v_prev = torch.from_numpy(rng.normal(size=(3, 40))), torch.from_numpy(rng.normal(size=(3, 40)))
	outs = []
	for op in (DIAOperator.from_scipy(A, device="cpu"), DenseOperator(torch.from_numpy(A.toarray()))):
		state = lanczos_state(3, torch.float64, "cpu")
		state.scal[0] = torch.tensor([2.0, 3.0, float("inf")])  # divisors of v_cur: probe 2 has broken down
		state.scal[2] = torch.tensor([0.5, 0.25, 1e-20])
		a, b = torch.empty(3, dtype=torch.float64), torch.empty(3, dtype=torch.float64)
		v = op.lanczos_sweep_step(v_cur, v_prev, state, a, b, 1e-8)
		outs.append((v, a, b, state.scal.clone()))
	for got, want in zip(*outs):
		torch.testing.assert_close(got, want, rtol=0, atol=1e-12)
	# Probe 2's q = v / inf = 0, so its residual is the tiny β·q_prev: it is done now.
	assert outs[0][3][3, 2] == 1.0 and outs[0][3][0, 2] == float("inf")


def _jacobi_batch(seed=0, nb=64, deg=20):
	rng = np.random.default_rng(seed)
	return rng.normal(size=(nb, deg)), rng.uniform(0.1, 1.0, size=(nb, deg - 1))


def test_eigh_tridiag_and_quadrature_match_jax():
	d, e = _jacobi_batch()
	rw, Y = eigh_tridiag(torch.from_numpy(d), torch.from_numpy(e))
	jrw, jY = jax_eigh_tridiag(jnp.asarray(d), jnp.asarray(e))
	np.testing.assert_allclose(rw.numpy(), np.asarray(jrw), rtol=0, atol=1e-12)
	np.testing.assert_allclose(np.abs(Y.numpy()), np.abs(np.asarray(jY)), rtol=0, atol=1e-12)  # up to sign
	for name in ("exp", "smoothstep", "softsign", "abs", "identity"):
		got = spectral_quad_form(torch.from_numpy(d), torch.from_numpy(e), param_callable(name))
		want = jax_spectral_quad_form(jnp.asarray(d), jnp.asarray(e), pt.special.param_callable(name))
		np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-12, err_msg=name)
	# log (eps-clamped) on a positive-definite batch
	d = np.abs(d) + 3.0
	got = spectral_quad_form(torch.from_numpy(d), torch.from_numpy(e), param_callable("log"))
	want = jax_spectral_quad_form(jnp.asarray(d), jnp.asarray(e), pt.special.param_callable("log"))
	np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-12)


def test_cov_update_matches_jax():
	rng = np.random.default_rng(2)
	st, jst = make_cov_state(3, torch.float64, device="cpu"), jax_make_cov_state(3, jnp.float64)
	for b in (5, 1, 17, 8):
		X = rng.normal(loc=2.0, size=(b, 3))
		st, jst = cov_update(st, torch.from_numpy(X)), jax_cov_update(jst, jnp.asarray(X))
		assert st.n == int(jst.n)
		np.testing.assert_allclose(st.mu.numpy(), np.asarray(jst.mu), rtol=0, atol=1e-12)
		np.testing.assert_allclose(st.S.numpy(), np.asarray(jst.S), rtol=0, atol=1e-12)
	# A JAX state carried across continues identically.
	port = cov_state_from_numpy(int(jst.n), np.asarray(jst.mu), np.asarray(jst.S), device="cpu")
	X = rng.normal(size=(6, 3))
	a, b = cov_update(port, torch.from_numpy(X)), jax_cov_update(jst, jnp.asarray(X))
	np.testing.assert_allclose(cov_matrix(a).numpy(), np.asarray(b.S) / (int(b.n) - 1), rtol=0, atol=1e-12)


def test_mean_estimator_matches_jax():
	rng = np.random.default_rng(4)
	est, jest = MeanEstimator(covariance=True, device="cpu"), pt.estimators.MeanEstimator(covariance=True)
	for b in (3, 9, 1):
		x = rng.normal(size=b)
		est.update(x)
		jest.update(x)
		np.testing.assert_allclose(est.estimate, jest.estimate, rtol=0, atol=1e-12)
		np.testing.assert_allclose(est.delta.numpy(), np.asarray(jest.delta), rtol=0, atol=1e-12)
	assert est.n_samples == jest.n_samples == 13
	np.testing.assert_allclose(est.converged_variance, jest.converged_variance, rtol=0, atol=1e-12)


@pytest.mark.parametrize("fun,orth", [("log", 0), ("log", 5), ("exp", 0)])
def test_matrix_function_quad_matches_jax(fun, orth):
	n = 2000
	L = _path_laplacian(n)
	X = np.random.default_rng(3).choice([-1.0, 1.0], size=(n, 12))
	got = MatrixFunction(DIAOperator.from_scipy(L, device="cpu"), fun, deg=20, orth=orth, t=-0.5).quad(torch.from_numpy(X))
	want = pt.MatrixFunction(JaxDIA.from_scipy(L), fun, deg=20, orth=orth, t=-0.5).quad(jnp.asarray(X))
	assert got.shape == (12,)
	np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10, atol=0)
