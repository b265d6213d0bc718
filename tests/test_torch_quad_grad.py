"""The degeneracy-stable derivative of the Gauss quadrature (``spectral_quad_form``).

The JAX package differentiates ``e₁ᵀ f(J) e₁`` by the Daleckii–Krein formula (a ``custom_jvp``,
``primate_tpu/integrate.py:37-84``), which has no ``1/(θᵢ − θⱼ)`` terms; the port's backward is its
transpose. These tests hold it:

- to ``jax.grad`` at Jacobi matrices where Ritz values meet or nodes are zero-padded (a probe that
  broke down before ``deg``), and at generic, batched and stacked-family inputs: within 1e-12 of the
  largest entry in float64, 1e-5 in float32;
- at the user level, on a DIA operator of 100 disjoint 10-row chains (every probe breaks down at step
  10), to the per-block closed form of the Fréchet derivative of ``log`` along symmetric directions that
  keep the blocks apart (1e-8), and to ``log``'s homogeneity, ``⟨∂bands, bands⟩ = Σ‖v‖²``; likewise on
  ``I + uuᵀ`` (breakdown at step 3) and on a Gram operator of equal blocks. JAX's own user-level gradient
  is not finite at these operators, so the closed forms are the reference there;
- in float32 on the same chains, where both packages' sweeps run past the breakdown (ROADMAP C.13);
- that a quadrature not under autograd keeps its bits, and that a ``fun`` closing over a tensor that
  requires a gradient is refused under autograd.

The chains and their closed form are ``tests/torch_cases.py``'s, which phase 26 (a) of
``chip_smoke.py`` runs at a million rows.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from primate_tpu import special as jax_special
from primate_tpu.integrate import spectral_quad_form as jax_quad_form

from primate_tpu.lanczos import lanczos as jax_lanczos
from primate_tpu.operators import MatrixFunction as JaxMatrixFunction
from primate_tpu.operators import DIAOperator as JaxDIA
from primate_tpu_torch import DIAOperator, MatrixFunction, lanczos, special
from primate_tpu_torch.integrate import spectral_quad_form
from primate_tpu_torch.operators import DenseOperator, GramOperator
from primate_tpu_torch.tridiag import eigh_tridiag
from torch_cases import chain_bands, chain_direction, chain_log_derivative, chain_probe_gram

torch.set_num_threads(1)
RTOL = {np.float64: 1e-12, np.float32: 1e-5}


def _np(x):
	return x.detach().cpu().numpy()


def _generic(seed, shape=(3,), k=6):
	rng = np.random.default_rng(seed)
	return rng.uniform(1.0, 3.0, shape + (k,)), rng.uniform(0.2, 0.8, shape + (k - 1,))


def _degenerate_batch():
	"""Three Jacobi matrices of 6 nodes: two equal blocks, a block and zero padding, a generic one."""
	d, e = _generic(1, shape=(3,))
	d[0], e[0] = [2.0, 1.0, 0.7, 2.0, 1.0, 0.7], [0.5, 0.3, 0.0, 0.5, 0.3]
	d[1], e[1] = [2.5, 1.5, 0.0, 0.0, 0.0, 0.0], [0.4, 0.0, 0.0, 0.0, 0.0]
	return d, e


CASES = {
	"split_exp": (lambda: ([2.0, 1.0, 0.0, 0.0], [0.5, 0.0, 0.0]), "exp"),
	"equal_blocks_exp": (lambda: ([2.0, 1.0, 2.0, 1.0], [0.5, 0.0, 0.5]), "exp"),
	"split_square": (lambda: ([2.0, 1.0, 0.0, 0.0], [0.5, 0.0, 0.0]), "square"),
	"split_log": (lambda: ([2.0, 1.0, 0.0, 0.0], [0.5, 0.0, 0.0]), "log"),
	"generic_exp": (lambda: _generic(0, shape=()), "exp"),
	"batched_log": (_degenerate_batch, "log"),
	"stacked_exp": (_degenerate_batch, "stacked_exp"),
}


def _funs(name):
	"""``(JAX function, port function)``: builtins through each package's ``param_callable``/``stacked``."""
	if name == "square":
		return (lambda x: x**2), (lambda x: x**2)
	if name == "stacked_exp":
		return jax_special.stacked("exp", [0.5, 1.0, 2.0]), special.stacked("exp", [0.5, 1.0, 2.0])
	return jax_special.param_callable(name), special.param_callable(name)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("case", list(CASES))
def test_quad_form_gradient_matches_jax(case, dtype):
	make, fname = CASES[case]
	d, e = (np.asarray(x, dtype) for x in make())
	fj, ft = _funs(fname)
	gj = jax.grad(lambda a, b: jnp.sum(jax_quad_form(a, b, fj)), argnums=(0, 1))(jnp.asarray(d), jnp.asarray(e))
	D, E = torch.from_numpy(d).requires_grad_(True), torch.from_numpy(e).requires_grad_(True)
	val = spectral_quad_form(D, E, ft)
	want_val = np.asarray(jax_quad_form(jnp.asarray(d), jnp.asarray(e), fj))
	assert val.shape == want_val.shape
	val.sum().backward()
	for got, want in ((D.grad, gj[0]), (E.grad, gj[1])):
		want = np.asarray(want)
		assert got.dtype == D.dtype and np.all(np.isfinite(_np(got)))
		scale = max(np.abs(want).max(), 1.0)
		assert np.abs(_np(got) - want).max() <= RTOL[dtype] * scale, (case, _np(got), want)


def test_length_k_subdiagonal_takes_no_gradient_on_its_leading_entry():
	"""An ``e`` of length k (leading zero, as ``quadrature`` accepts) gets the same gradient shifted
	by one, and 0 on the entry the Jacobi matrix does not use."""
	d, e = _generic(2, shape=(2,))
	D1, E1 = torch.from_numpy(d).requires_grad_(True), torch.from_numpy(e).requires_grad_(True)
	spectral_quad_form(D1, E1, torch.exp).sum().backward()
	e_full = np.concatenate([np.zeros((2, 1)), e], axis=-1)
	D2, E2 = torch.from_numpy(d).requires_grad_(True), torch.from_numpy(e_full).requires_grad_(True)
	spectral_quad_form(D2, E2, torch.exp).sum().backward()
	assert torch.equal(D1.grad, D2.grad) and torch.equal(E2.grad[:, 1:], E1.grad) and not E2.grad[:, 0].any()


# -- user level: a DIA operator of disjoint chains ------------------------------------------------

NB, BS, NV = 100, 10, 8  # 100 chains of 10 rows: n = 1000
N = NB * BS
OFFSETS = (-1, 0, 1)


def _block_frechet(lam, U, f, fp):
	"""``E ↦ D f(B)[E] = U (L ∘ Uᵀ E U) Uᵀ`` for ``B = U diag(λ) Uᵀ`` with distinct eigenvalues."""
	dl = lam[:, None] - lam[None, :]
	same = np.eye(len(lam), dtype=bool)
	L = np.where(same, fp(lam)[:, None], (f(lam)[:, None] - f(lam)[None, :]) / np.where(same, 1.0, dl))
	return lambda E: U @ (L * (U.T @ E @ U)) @ U.T


@pytest.fixture(scope="module")
def chain_probes():
	return np.random.default_rng(5).choice([-1.0, 1.0], size=(N, NV))


def _chain_grad(V, orth, dtype=np.float64):
	bands = torch.from_numpy(chain_bands(NB, BS).astype(dtype)).requires_grad_(True)
	op = DIAOperator(bands, OFFSETS, (N, N))
	q = MatrixFunction(op, "log", deg=20, orth=orth, device="cpu").quad(torch.from_numpy(V.astype(dtype)))
	q.sum().backward()
	return _np(bands.grad).astype(np.float64)


@pytest.mark.parametrize("orth", [0, 5])
def test_disjoint_chains_gradient_matches_the_closed_form(chain_probes, orth):
	V = chain_probes
	g = _chain_grad(V, orth)
	assert np.all(np.isfinite(g))
	S = chain_probe_gram(V, BS)
	for seed in (100, 101):
		H = chain_direction(NB, BS, seed)
		want = chain_log_derivative(BS, H, S)
		assert abs(float((g * H).sum()) - want) <= 1e-8 * max(abs(want), 1.0), (orth, seed, float((g * H).sum()), want)


@pytest.mark.parametrize("orth", [0, 5])
def test_disjoint_chains_gradient_is_homogeneous(chain_probes, orth):
	"""``log(cA) = log(c)·I + log(A)``, so ``⟨∂bands, bands⟩ = Σ‖v‖²``."""
	g = _chain_grad(chain_probes, orth)
	want = float((chain_probes**2).sum())
	assert abs(float((g * chain_bands(NB, BS)).sum()) - want) <= 1e-8 * want


def test_float32_sweep_runs_past_the_breakdown_as_in_jax(chain_probes):
	"""ROADMAP C.13, pinned at a size where it shows. Both packages stop a sweep where β ≤ √n·rtol
	(rtol 1e-8, ``primate_tpu/lanczos.py:254``). In float32 the chains' exact breakdown at step 10 leaves
	β₁₀ ≈ 3e-6, above √1000·1e-8, so the JAX package's sweep and the port's run on through rounding
	noise to deg 20 on the same probes; the steps before agree to float32. The gradient stays finite
	and homogeneous (1e-5), but its directional derivatives leave the closed form (here by 0.16-0.57%
	along three directions), no farther than the JAX package's float32 gradient does (0.33-1.35%). A stop
	rule that sees this breakdown turns this test into the closed-form check at float32's limits."""
	V32 = chain_probes.astype(np.float32)
	bands32 = chain_bands(NB, BS).astype(np.float32)
	op = DIAOperator(torch.from_numpy(bands32), OFFSETS, (N, N))
	a, b = (_np(x) for x in lanczos(op, v0=torch.from_numpy(V32), deg=20, orth=0))
	ja, jb = (np.asarray(x) for x in jax_lanczos(JaxDIA(jnp.asarray(bands32), OFFSETS, (N, N)), v0=jnp.asarray(V32), deg=20, orth=0))
	tol = N**0.5 * 1e-8
	for beta in (b, jb):
		assert beta.shape == (19, NV) and np.all((tol < beta[BS - 1]) & (beta[BS - 1] < 1e-5)), beta[BS - 1]
	assert np.abs(a[:BS] - ja[:BS]).max() <= 1e-5 * np.abs(ja[:BS]).max()
	assert np.abs(b[: BS - 1] - jb[: BS - 1]).max() <= 1e-5 * np.abs(jb[: BS - 1]).max()
	g = _chain_grad(chain_probes, 0, np.float32)
	assert np.all(np.isfinite(g))
	want = float((chain_probes**2).sum())
	assert abs(float((g * chain_bands(NB, BS)).sum()) - want) <= 1e-5 * want
	quad = lambda x: jnp.sum(JaxMatrixFunction(JaxDIA(x, OFFSETS, (N, N)), "log", deg=20, orth=0).quad(jnp.asarray(V32)))  # noqa: E731
	gj = np.asarray(jax.grad(quad)(jnp.asarray(bands32))).astype(np.float64)
	S = chain_probe_gram(chain_probes, BS)
	errs = {}
	for seed in (100, 101, 102):
		H = chain_direction(NB, BS, seed)
		closed = chain_log_derivative(BS, H, S)
		errs[seed] = tuple(abs(float((x * H).sum()) - closed) / abs(closed) for x in (g, gj))
	assert max(e[0] for e in errs.values()) <= max(e[1] for e in errs.values()), errs


def test_low_rank_update_gradient_matches_the_frechet_derivative():
	"""``Σ quad(V)`` of ``log(I + uuᵀ)`` with u of rank 2 (every probe breaks down at step 3): the
	gradient is finite and its directional derivative along a symmetric direction is the exact
	Fréchet derivative ``Σ_p v_pᵀ D log(A)[E] v_p``."""
	n, nv = 48, 4
	rng = np.random.default_rng(3)
	u = rng.normal(size=(n, 2))
	A = np.eye(n) + u @ u.T
	V = rng.choice([-1.0, 1.0], size=(n, nv))
	At = torch.from_numpy(A).requires_grad_(True)
	q = MatrixFunction(DenseOperator(At, device="cpu"), "log", deg=10, orth=0, device="cpu").quad(torch.from_numpy(V))
	q.sum().backward()
	g = _np(At.grad)
	assert np.all(np.isfinite(g))
	lam, Ue = np.linalg.eigh(A)
	E = rng.normal(size=(n, n))
	E = E + E.T
	dl = lam[:, None] - lam[None, :]
	near = np.abs(dl) <= 1e-9 * lam.max()
	L = np.where(near, 1.0 / lam[:, None], (np.log(lam)[:, None] - np.log(lam)[None, :]) / np.where(near, 1.0, dl))
	want = float(np.einsum("ip,ij,jp->", V, Ue @ (L * (Ue.T @ E @ Ue)) @ Ue.T, V))
	assert abs(float((g * E).sum()) - want) <= 1e-8 * abs(want)


def test_gram_quadrature_of_equal_blocks_gradient_matches_the_closed_form():
	"""The Gram quadrature ``vᵀ log(XᵀX) v`` through Golub-Kahan on X block-diagonal with 6 equal
	4×4 blocks (every probe's bidiagonalisation stops after 4 steps): a finite gradient whose
	directional derivative along a block-preserving H is ``Σ vᵀ D log(XᵀX)[XᵀH + HᵀX] v``."""
	rng = np.random.default_rng(7)
	C = rng.normal(size=(4, 4)) + 3.0 * np.eye(4)
	X = np.kron(np.eye(6), C)
	n = X.shape[0]
	V = rng.choice([-1.0, 1.0], size=(n, 3))
	Xt = torch.from_numpy(X).requires_grad_(True)
	q = MatrixFunction(GramOperator(Xt, device="cpu"), "log", deg=8, orth=0, device="cpu").quad(torch.from_numpy(V))
	q.sum().backward()
	g = _np(Xt.grad)
	assert np.all(np.isfinite(g))
	H = np.kron(np.eye(6), np.ones((4, 4))) * rng.normal(size=(n, n))
	lam, U = np.linalg.eigh(C.T @ C)
	frechet = _block_frechet(lam, U, np.log, lambda x: 1.0 / x)
	want = 0.0
	for b in range(6):
		s = slice(4 * b, 4 * b + 4)
		Hb = H[s, s]
		want += np.einsum("ip,ij,jp->", V[s], frechet(C.T @ Hb + Hb.T @ C), V[s])
	assert abs(float((g * H).sum()) - want) <= 1e-8 * max(abs(want), 1.0)


# -- values keep their bits -------------------------------------------------------------------------


@pytest.mark.parametrize("fname", ["log", "stacked_exp"])
def test_value_keeps_its_bits(fname):
	"""Off autograd the value is the Golub-Welsch sum as it was; under autograd it is the same bits."""
	d, e = (torch.from_numpy(x) for x in _degenerate_batch())
	fun = _funs(fname)[1]
	theta, Y = eigh_tridiag(d, e)
	want = torch.sum(fun(theta) * Y[..., 0, :] ** 2, dim=-1)
	assert torch.equal(spectral_quad_form(d, e, fun), want)
	assert torch.equal(spectral_quad_form(d.clone().requires_grad_(True), e, fun).detach(), want)


def test_quad_value_under_autograd_keeps_its_bits(chain_probes):
	"""``MatrixFunction.quad`` on the chains: the same bits with and without a gradient on the bands."""
	V = torch.from_numpy(chain_probes)
	bands = torch.from_numpy(chain_bands(NB, BS))
	plain = MatrixFunction(DIAOperator(bands, OFFSETS, (N, N)), "log", deg=20, orth=0, device="cpu").quad(V)
	leaf = bands.clone().requires_grad_(True)
	tracked = MatrixFunction(DIAOperator(leaf, OFFSETS, (N, N)), "log", deg=20, orth=0, device="cpu").quad(V)
	with torch.no_grad():
		off = MatrixFunction(DIAOperator(leaf, OFFSETS, (N, N)), "log", deg=20, orth=0, device="cpu").quad(V)
	assert torch.equal(plain, off)
	assert torch.allclose(plain, tracked.detach(), rtol=1e-12, atol=0)


# -- fun takes no gradient ----------------------------------------------------------------------------


@pytest.mark.parametrize("bands_grad", [True, False], ids=["bands_and_closure", "closure_only"])
def test_closure_with_a_gradient_is_refused(bands_grad):
	"""``fun`` is not differentiated (a nondiff argument in the JAX package): a closure over a tensor that
	requires a gradient raises under autograd, whether or not ``d`` and ``e`` require one, and is fine
	without autograd."""
	d, e = (torch.from_numpy(x) for x in _generic(3, shape=(2,)))
	t = torch.tensor(0.5, dtype=torch.float64, requires_grad=True)
	fun = lambda x: torch.exp(-t * x)  # noqa: E731
	D = d.clone().requires_grad_(bands_grad)
	with pytest.raises(NotImplementedError, match="closes over a tensor"):
		spectral_quad_form(D, e, fun)
	with torch.no_grad():
		assert torch.isfinite(spectral_quad_form(D, e, fun)).all()
