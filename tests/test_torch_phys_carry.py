"""The Lanczos sweep on the halo-padded carry (JAX's ``phys_spec``, ``DIAOperator.carry_spec`` in the
port): the plain versions of the step's two passes on a padded carry against JAX's
``dia_matmat_t_phys`` (interpret mode) and against the flat step, and ``lanczos_block_op(phys=True)``
against JAX's ``phys=True`` and ``phys=False`` sweeps, on the same numpy inputs."""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import jax.numpy as jnp

from primate_tpu.lanczos import lanczos_block_op as jax_lanczos_block_op
from primate_tpu.operators.sparse import CSROperator as JaxCSR
from primate_tpu.operators.sparse import DIAOperator as JaxDIA
from primate_tpu.ops.dia_pallas import HALO, LANE_TILE, dia_matmat_t_phys
from primate_tpu_torch import CSROperator, DIAOperator
from primate_tpu_torch.lanczos import lanczos_block_op
from primate_tpu_torch.operators.base import PaddedRows
from primate_tpu_torch.ops import dia

torch.set_num_threads(1)

# Offsets inside the step kernel's 16-row staging (kHalo) and beyond it, up to JAX's 128-lane HALO.
OFFSETS = [(-1, 0, 1), (-128, -17, -16, -3, 0, 5, 16, 17, 128)]
TOL = {np.float64: 1e-12, np.float32: 1e-5}


def _band_op(n, offsets, seed, dtype=np.float64):
	"""A symmetric banded matrix with the given offsets (scipy CSR)."""
	rng = np.random.default_rng(seed)
	A = sps.diags([rng.normal(size=n - abs(o)) for o in offsets], offsets).tocsr()
	A = (A + A.T).tocsr() + sps.eye(n) * 2 * len(offsets)
	return A.astype(dtype)


def _mid_sweep(nv, dtype, rng):
	"""A state in the middle of a sweep (divisors and β away from 1) and its torch twin."""
	state = dia.lanczos_state(nv, torch.from_numpy(np.zeros(0, dtype)).dtype, "cpu")
	for row in (dia.DIV_CUR, dia.DIV_PREV, dia.BETA):
		state.scal[row] = torch.from_numpy(rng.uniform(0.5, 2.0, size=nv).astype(dtype))
	return state


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("offsets", OFFSETS, ids=["tridiagonal", "wide"])
def test_plain_passes_on_a_padded_carry_match_jax_phys_kernel(dtype, offsets):
	"""Pass A on a padded carry (n = 1001, not a multiple of 4; nv = 5, not of 8) against JAX's
	halo-padded stencil followed by the β-axpy and α in numpy, then pass B; and both passes
	against the flat plain step on the same rows. The carry's margins come out exactly zero."""
	tol = TOL[dtype]
	n, nv = 1001, 5
	rng = np.random.default_rng(1)
	bands = rng.normal(size=(len(offsets), n)).astype(dtype)
	op = DIAOperator.from_numpy(bands, offsets, (n, n), device="cpu")
	spec = op.carry_spec(nv)
	vl = 16 // bands.itemsize
	assert spec.lo % vl == 0 and spec.ld % vl == 0 and spec.lo >= max(abs(o) for o in offsets)
	assert spec.ld - spec.lo - n >= max(abs(o) for o in offsets) and spec.n == n
	v_cur, v_prev = (rng.normal(size=(nv, n)).astype(dtype) for _ in range(2))
	state = _mid_sweep(nv, dtype, rng)
	s = state.scal.numpy()
	q, q_prev = v_cur / s[dia.DIV_CUR, :, None], v_prev / s[dia.DIV_PREV, :, None]

	n_dom = -(-n // LANE_TILE) * LANE_TILE
	bands_dom = np.zeros((len(offsets), n_dom), dtype)
	bands_dom[:, :n] = bands
	Xp = np.zeros((nv, n_dom + 2 * HALO), dtype)
	Xp[:, HALO : HALO + n] = q
	Aq = np.asarray(dia_matmat_t_phys(jnp.asarray(bands_dom), jnp.asarray(Xp), offsets, interpret=True))
	w_want = Aq[:, HALO : HALO + n] - s[dia.BETA, :, None] * q_prev
	alpha_want = np.sum(w_want * q, axis=1)
	v_want = w_want - alpha_want[:, None] * q
	beta_want = np.sqrt(np.sum(v_want * v_want, axis=1))

	cb = op._carry_bands(spec)
	apply_pad = lambda X: dia.dia_stencil_t_ref(cb, op.offsets_t, X)  # noqa: E731
	apply_flat = lambda X: dia.dia_stencil_t_ref(op.bands, op.offsets_t, X)  # noqa: E731
	pads = [spec.pad(torch.from_numpy(x)) for x in (v_cur, v_prev)]
	alpha, beta = torch.empty(nv, dtype=state.scal.dtype), torch.empty(nv, dtype=state.scal.dtype)
	st_flat = dia.LanczosState(state.scal.clone(), state.ticket.clone())
	w = dia.lanczos_sweep_pass_a_ref(apply_pad, *pads, state, alpha, spec=spec)
	scale = np.abs(w_want).max()
	np.testing.assert_allclose(spec.rows(w).numpy(), w_want, rtol=0, atol=tol * scale)
	np.testing.assert_allclose(alpha.numpy(), alpha_want, rtol=0, atol=tol * np.abs(alpha_want).max())
	v = dia.lanczos_sweep_pass_b_ref(pads[0], w, state, beta, 1e-8, spec=spec)
	np.testing.assert_allclose(spec.rows(v).numpy(), v_want, rtol=0, atol=tol * np.abs(v_want).max())
	np.testing.assert_allclose(beta.numpy(), beta_want, rtol=0, atol=tol * beta_want.max())
	assert not v[:, : spec.lo].any() and not v[:, spec.lo + n :].any()

	a_flat, b_flat = torch.empty_like(alpha), torch.empty_like(beta)
	v_flat = dia.lanczos_sweep_step_ref(apply_flat, torch.from_numpy(v_cur), torch.from_numpy(v_prev), st_flat, a_flat, b_flat, 1e-8)
	np.testing.assert_allclose(spec.rows(v).numpy(), v_flat.numpy(), rtol=0, atol=tol * np.abs(v_want).max())
	np.testing.assert_allclose(alpha.numpy(), a_flat.numpy(), rtol=tol, atol=0)
	np.testing.assert_allclose(beta.numpy(), b_flat.numpy(), rtol=tol, atol=0)
	np.testing.assert_allclose(state.scal.numpy(), st_flat.scal.numpy(), rtol=tol, atol=0)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("offsets", OFFSETS, ids=["tridiagonal", "wide"])
def test_twenty_steps_on_a_padded_carry_keep_zero_margins(dtype, offsets):
	"""20 whole steps of ``lanczos_dia_sweep_step`` (its plain version on the CPU) on the padded
	carry against the flat carry, and pass A alone (``lanczos_dia_step``, the ``orth > 0`` step)
	on both: α and β agree, and the margins stay exactly zero after every step."""
	tol = TOL[dtype]
	n, nv, deg = 1001, 5, 20
	A = _band_op(n, [o for o in offsets if o >= 0], seed=2, dtype=dtype)
	op = DIAOperator.from_scipy(A, device="cpu")
	spec = op.carry_spec(nv)
	rng = np.random.default_rng(3)
	V = rng.normal(size=(nv, n)).astype(dtype)
	V /= np.linalg.norm(V, axis=1, keepdims=True)
	runs = {}
	for name, sp, bands in (("pad", spec, op._carry_bands(spec)), ("flat", None, op.bands)):
		state = dia.lanczos_state(nv, op.dtype, "cpu")
		v_cur = sp.pad(torch.from_numpy(V)) if sp else torch.from_numpy(V)
		v_prev = torch.zeros_like(v_cur)
		ab = torch.empty((2, deg, nv), dtype=op.dtype)
		for j in range(deg):
			v_prev, v_cur = v_cur, dia.lanczos_dia_sweep_step(bands, op.offsets_t, v_cur, v_prev, state, ab[0, j], ab[1, j], 1e-8, sp)
			if sp:
				assert not v_cur[:, : sp.lo].any() and not v_cur[:, sp.lo + n :].any(), j
		runs[name] = ab
		q = sp.pad(torch.from_numpy(V)) if sp else torch.from_numpy(V)
		runs[name + "_step"] = dia.lanczos_dia_step(bands, op.offsets_t, q, torch.zeros_like(q), torch.ones(nv, dtype=op.dtype), sp)
	np.testing.assert_allclose(runs["pad"].numpy(), runs["flat"].numpy(), rtol=0, atol=tol * float(runs["flat"].abs().max()))
	(v_p, a_p), (v_f, a_f) = runs["pad_step"], runs["flat_step"]
	assert torch.equal(spec.rows(v_p), v_f) and not v_p[:, : spec.lo].any() and not v_p[:, spec.lo + n :].any()
	np.testing.assert_allclose(a_p.numpy(), a_f.numpy(), rtol=tol, atol=0)


@pytest.mark.parametrize("orth", [0, 5])
def test_lanczos_block_op_phys_matches_jax(orth, monkeypatch):
	"""``lanczos_block_op(phys=True)`` on a real DIA operator against JAX's ``phys=True`` (the Pallas
	phys kernel in interpret mode) and ``phys=False``: α, β and the basis within 1e-8 (float64). The
	sweep carries the padded layout through the operator's step hook."""
	n, nv, deg = 1000, 8, 20
	A = _band_op(n, (0, 1, 37), seed=4)
	V0 = np.random.default_rng(5).normal(size=(n, nv))
	ncv = deg
	op = DIAOperator.from_scipy(A, device="cpu")
	seen = []
	hook = "lanczos_sweep_step" if orth == 0 else "lanczos_step"
	real = getattr(DIAOperator, hook)
	monkeypatch.setattr(DIAOperator, hook, lambda self, *a, layout=None, **k: (seen.append(layout), real(self, *a, layout=layout, **k))[1])
	got = lanczos_block_op(op, torch.from_numpy(V0), deg=deg, ncv=ncv, orth=orth, phys=True)
	assert len(seen) == deg and all(isinstance(lay, PaddedRows) and lay.spec == op.carry_spec(nv) for lay in seen)
	flat = lanczos_block_op(op, torch.from_numpy(V0), deg=deg, ncv=ncv, orth=orth, phys=False)
	assert got.Q.shape == (ncv, n, nv)
	jop = JaxDIA.from_scipy(A)
	for phys in (True, False):
		want = jax_lanczos_block_op(jop, jnp.asarray(V0), deg=deg, ncv=ncv, orth=orth, return_basis=True, phys=phys)
		for g, w in ((got.alphas, want.alphas), (got.betas, want.betas), (got.Q, want.Q)):
			np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-8)
	for g, w in ((got.alphas, flat.alphas), (got.betas, flat.betas), (got.Q, flat.Q)):
		np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=1e-12)


def test_phys_two_pass_y_and_selective_match_flat():
	"""``coeffs`` (the second pass of f(A)V, ``y`` on the rows) and selective re-orthogonalisation
	on the padded carry give the flat sweep's results."""
	n, nv, deg = 600, 3, 12
	op = DIAOperator.from_scipy(_band_op(n, (0, 2, 20), seed=6), device="cpu")
	V0 = torch.from_numpy(np.random.default_rng(7).normal(size=(n, nv)))
	c = torch.from_numpy(np.random.default_rng(8).normal(size=(deg, nv)))
	for kw in (dict(orth=0, ncv=2, return_basis=False, coeffs=c), dict(orth=3, ncv=4, return_basis=False, coeffs=c),
			dict(ncv=deg, selective=True)):
		got, want = (lanczos_block_op(op, V0, deg=deg, phys=p, **kw) for p in (True, False))
		for name in ("alphas", "betas", "y", "Q"):
			g, w = getattr(got, name), getattr(want, name)
			assert (g is None) == (w is None), name
			if g is not None:
				np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=1e-12, err_msg=name)


@pytest.mark.parametrize("kind", ["csr", "complex"])
def test_phys_true_without_a_padded_carry_raises(kind):
	"""A CSR or complex operator has no padded carry: the port raises ValueError (JAX warns and runs
	its flat sweep)."""
	n, nv = 64, 8
	A = _band_op(n, (0, 1), seed=9)
	V0 = np.random.default_rng(10).normal(size=(n, nv))
	if kind == "csr":
		op, jop, V = CSROperator.from_scipy(A, device="cpu"), JaxCSR.from_scipy(A), V0
	else:
		op, jop, V = DIAOperator.from_scipy(A.astype(np.complex128), device="cpu"), JaxDIA.from_scipy(A.astype(np.complex128)), V0 + 0j
	with pytest.raises(ValueError, match="phys"):
		lanczos_block_op(op, torch.from_numpy(V), deg=4, ncv=4, phys=True)
	with pytest.warns(UserWarning, match="phys=True"):
		jax_lanczos_block_op(jop, jnp.asarray(V), deg=4, ncv=4, phys=True)
