"""The complex (Hermitian) Lanczos step on a DIA operator, in the port against the JAX package.

A complex ``DIAOperator``'s sweep step is ``ops.dia.lanczos_dia_sweep_step`` (``orth = 0``) and its
pass A ``ops.dia.lanczos_dia_step`` (``orth > 0``), as a real one's: on the card the complex64 and
complex128 step kernels, here their plain versions. Held here: the sweep's α and β against JAX's
``lanczos_block_op`` (complex128 at 1e-10, complex64 at ``C64_TOL``), a probe that breaks down, the
plain passes against JAX's probe-major apply, the routed step against the base class's plain step
bit for bit (the route a complex operator took before), and the wrappers' refusal of a complex state
or β. Inputs are made with numpy from a seed. The card's tests of the kernels themselves are in
``tests/test_torch_cuda_kernels.py`` (marker ``cuda``)."""

import os
import sys

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import jax.numpy as jnp

from primate_tpu.lanczos import lanczos_block_op as jax_lanczos_block_op
from primate_tpu.operators.sparse import DIAOperator as JaxDIA

from primate_tpu_torch import DIAOperator
from primate_tpu_torch.lanczos import lanczos_block_op
from primate_tpu_torch.operators.base import LinearOperator
from primate_tpu_torch.ops import dia

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from chip_smoke import hofstadter_csr  # noqa: E402

torch.set_num_threads(1)
DTYPES = {"complex64": (torch.complex64, np.complex64), "complex128": (torch.complex128, np.complex128)}
# complex64 against JAX: both sweeps run in complex64 with float32 α and β, their sums in other
# orders; over 16 steps on these lattices they differ by at most 3.2e-6 (about 8 float32 ulps of
# ‖H‖ ≈ 4), so the limit leaves a factor of 6. Absolute, on α and β of size about 1-4.
C64_TOL = 2e-5
# A lattice of n = 10 · 12 sites, and one of n = 5 · 9 = 45 (odd: the complex64 kernel's scalar path).
LATTICES = {"10x12": (10, 12), "5x9_odd": (5, 9)}


def _tol(dtype):
	return C64_TOL if dtype == "complex64" else 1e-10


def _lattice(name, dtype):
	"""The Hofstadter Hamiltonian (flux 1/5) plus a seeded real diagonal, so α is not zero by symmetry."""
	H = hofstadter_csr(*LATTICES[name], 0.2)
	H = (H + sps.diags(np.random.default_rng(3).uniform(-1.0, 1.0, H.shape[0]))).tocsr().astype(DTYPES[dtype][1])
	return H, JaxDIA.from_scipy(H), DIAOperator.from_scipy(H, dtype=DTYPES[dtype][0], device="cpu")


def _probes(n, nv, dtype, seed):
	rng = np.random.default_rng(seed)
	return (rng.normal(size=(n, nv)) + 1j * rng.normal(size=(n, nv))).astype(DTYPES[dtype][1])


@pytest.mark.parametrize("lattice", list(LATTICES))
@pytest.mark.parametrize("orth", [0, 5])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_complex_dia_sweep_matches_jax(dtype, orth, lattice):
	"""α and β of ``lanczos_block_op`` on a complex DIA operator (6 probes, deg 16) against JAX's on the
	same probe block: real, in the real dtype of the operator's."""
	_, jop, op = _lattice(lattice, dtype)
	V0 = _probes(op.shape[0], 6, dtype, seed=4)
	kw = dict(deg=16, ncv=max(2, orth), orth=orth, return_basis=False)
	out = lanczos_block_op(op, torch.from_numpy(V0), **kw)
	want = jax_lanczos_block_op(jop, jnp.asarray(V0), **kw)
	assert out.alphas.dtype == out.betas.dtype == DTYPES[dtype][0].to_real()
	np.testing.assert_allclose(out.alphas.numpy(), np.asarray(want.alphas), rtol=0, atol=_tol(dtype))
	np.testing.assert_allclose(out.betas.numpy(), np.asarray(want.betas), rtol=0, atol=_tol(dtype))


@pytest.mark.parametrize("orth", [0, 5])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_complex_breakdown_gives_zeros_as_jax(dtype, orth):
	"""A probe started in a 3-dimensional invariant subspace of a complex tridiagonal Hermitian
	operator breaks down at step 3: α and β are exactly zero after it, in both packages."""
	n = 40
	off = -0.5 * np.exp(1j * np.linspace(0.0, 3.0, n - 1))
	off[2] = 0.0
	A = sps.diags([off.conj(), np.linspace(1.0, 4.0, n), off], [-1, 0, 1]).tocsr().astype(DTYPES[dtype][1])
	V0 = _probes(n, 3, dtype, seed=6)
	V0[3:, 0] = 0.0
	rtol = 1e-5 if dtype == "complex64" else 1e-8  # complex64 leaves β₃ at its round-off
	kw = dict(deg=8, ncv=8, orth=orth, rtol=rtol, return_basis=False)
	out = lanczos_block_op(DIAOperator.from_scipy(A, dtype=DTYPES[dtype][0], device="cpu"), torch.from_numpy(V0), **kw)
	want = jax_lanczos_block_op(JaxDIA.from_scipy(A), jnp.asarray(V0), **kw)
	a, b = out.alphas.numpy(), out.betas.numpy()
	assert not a[3:, 0].any() and not b[3:, 0].any() and abs(b[2, 0]) < 1e-5
	assert not np.asarray(want.alphas)[3:, 0].any() and not np.asarray(want.betas)[3:, 0].any()
	np.testing.assert_allclose(a, np.asarray(want.alphas), rtol=0, atol=_tol(dtype))
	np.testing.assert_allclose(b, np.asarray(want.betas), rtol=0, atol=_tol(dtype))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_complex_plain_passes_match_jax_apply(dtype):
	"""The plain versions of the complex kernels against JAX's probe-major apply on the same blocks:
	pass A alone (``lanczos_dia_step_ref``: ``v = A q − β q_prev``, ``α = Re Σ conj(q) v``), and one
	whole sweep step (``lanczos_sweep_step_ref`` through ``lanczos_dia_sweep_step``) from a mid-sweep
	state with a broken-down probe (its divisor inf: q = 0, not NaN)."""
	_, jop, op = _lattice("10x12", dtype)
	n, nv = op.shape[0], 5
	rtype, tol = DTYPES[dtype][0].to_real(), (2e-6 if dtype == "complex64" else 1e-13)
	rng = np.random.default_rng(7)
	q, qp = _probes(n, nv, dtype, 8).T.copy(), _probes(n, nv, dtype, 9).T.copy()
	beta = rng.uniform(0.5, 1.5, nv)
	Aq = np.asarray(jop.matmat_t(jnp.asarray(q))).astype(np.complex128)
	v_want = Aq - beta[:, None] * qp
	alpha_want = np.real(np.sum(q.conj() * v_want, axis=1))
	v, alpha = dia.lanczos_dia_step(op.bands, op.offsets_t, torch.from_numpy(q), torch.from_numpy(qp), torch.tensor(beta, dtype=rtype))
	assert v.dtype == DTYPES[dtype][0] and alpha.dtype == rtype
	np.testing.assert_allclose(v.numpy(), v_want, rtol=0, atol=tol * np.abs(v_want).max())
	np.testing.assert_allclose(alpha.numpy(), alpha_want, rtol=0, atol=tol * np.linalg.norm(v_want, axis=1).max())

	div, divp = rng.uniform(0.5, 2.0, nv), rng.uniform(0.5, 2.0, nv)
	div[0] = np.inf
	state = dia.lanczos_state(nv, rtype, "cpu")
	state.scal[dia.DIV_CUR] = torch.tensor(div, dtype=rtype)
	state.scal[dia.DIV_PREV] = torch.tensor(divp, dtype=rtype)
	state.scal[dia.BETA] = torch.tensor(beta, dtype=rtype)
	state.scal[dia.DONE, 0] = 1
	a_out, b_out = torch.empty(nv, dtype=rtype), torch.empty(nv, dtype=rtype)
	v = dia.lanczos_dia_sweep_step(op.bands, op.offsets_t, torch.from_numpy(q), torch.from_numpy(qp), state, a_out, b_out, 1e-8)
	qn = q / div[:, None]
	w = np.asarray(jop.matmat_t(jnp.asarray(qn.astype(q.dtype)))).astype(np.complex128) - beta[:, None] * (qp / divp[:, None])
	a = np.real(np.sum(qn.conj() * w, axis=1))
	v_want = w - a[:, None] * qn
	b = np.linalg.norm(v_want, axis=1)
	assert bool(torch.isfinite(torch.view_as_real(v)).all())
	np.testing.assert_allclose(v.numpy(), v_want, rtol=0, atol=tol * np.abs(v_want).max())
	assert a_out[0] == 0 and b_out[0] == 0  # done before the step
	np.testing.assert_allclose(a_out[1:].numpy(), a[1:], rtol=0, atol=tol * b.max())
	np.testing.assert_allclose(b_out[1:].numpy(), b[1:], rtol=tol)
	np.testing.assert_allclose(state.scal[dia.DIV_CUR].numpy(), b, rtol=tol)
	assert torch.equal(state.scal[dia.DONE], torch.tensor([1.0, 0, 0, 0, 0], dtype=rtype))


class _PlainStepDIA(DIAOperator):
	"""A complex DIA operator whose steps are the base class's plain ones: the route every complex
	DIA sweep took before its steps went to the step kernels' wrappers."""

	lanczos_step = LinearOperator.lanczos_step
	lanczos_sweep_step = LinearOperator.lanczos_sweep_step


@pytest.mark.parametrize("lattice", list(LATTICES))
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_routed_complex_step_equals_the_plain_step(dtype, lattice):
	"""On the CPU the routed complex step (``DIAOperator.lanczos_step``/``lanczos_sweep_step``, the step
	kernels' wrappers running their plain versions) gives α, β, v and the state bit for bit what the
	base class's plain step gives; and so do whole sweeps at ``orth`` 0 and 5, with the basis and ``y``."""
	_, _, op = _lattice(lattice, dtype)
	plain = _PlainStepDIA(op.bands, op.offsets, op.shape)
	ct, rtype = DTYPES[dtype][0], DTYPES[dtype][0].to_real()
	n, nv = op.shape[0], 6
	rng = np.random.default_rng(10)
	q, qp = torch.from_numpy(_probes(n, nv, dtype, 11).T.copy()), torch.from_numpy(_probes(n, nv, dtype, 12).T.copy())
	beta = torch.tensor(rng.uniform(0.5, 1.5, nv), dtype=rtype)
	for (v1, a1), (v2, a2) in [(op.lanczos_step(q, qp, beta), plain.lanczos_step(q, qp, beta))]:
		assert torch.equal(v1, v2) and torch.equal(a1, a2) and a1.dtype == rtype
	runs = []
	for o in (op, plain):
		state = dia.lanczos_state(nv, rtype, "cpu")
		state.scal[dia.DIV_CUR] = 2.0
		state.scal[dia.BETA] = beta
		vc, vp, outs = q, qp, []
		for _ in range(4):
			a, b = torch.empty(nv, dtype=rtype), torch.empty(nv, dtype=rtype)
			vp, vc = vc, o.lanczos_sweep_step(vc, vp, state, a, b, 1e-8)
			outs += [vc.clone(), a, b, state.scal.clone()]
		runs.append(outs)
	assert all(torch.equal(x, y) for x, y in zip(*runs))
	V0 = torch.from_numpy(_probes(n, nv, dtype, 13))
	coeffs = torch.tensor(rng.normal(size=(12, nv)), dtype=rtype)
	for orth in (0, 5):
		got, want = (lanczos_block_op(o, V0, deg=12, ncv=12, orth=orth, coeffs=coeffs) for o in (op, plain))
		for x, y in ((got.alphas, want.alphas), (got.betas, want.betas), (got.Q, want.Q), (got.y, want.y)):
			assert x.dtype == y.dtype and torch.equal(x, y)
		assert got.Q.dtype == ct


def test_step_wrappers_refuse_a_complex_state_or_beta():
	"""The step's state, β and outputs are real for a complex carry: a complex one raises ``TypeError``
	(on the card ``check_cuda`` refuses it too); a state of the wrong shape raises ``ValueError``."""
	_, _, op = _lattice("10x12", "complex128")
	n, nv = op.shape[0], 4
	q = torch.from_numpy(_probes(n, nv, "complex128", 14).T.copy())
	bands, offs = op.bands, op.offsets_t
	with pytest.raises(TypeError, match="beta"):
		dia.lanczos_dia_step(bands, offs, q, q, torch.ones(nv, dtype=torch.complex128))
	out = torch.empty(nv, dtype=torch.float64)
	with pytest.raises(TypeError, match="scal"):
		dia.lanczos_dia_sweep_step(bands, offs, q, q, dia.lanczos_state(nv, torch.complex128, "cpu"), out, out.clone(), 1e-8)
	with pytest.raises(TypeError, match="alpha_out"):
		state = dia.lanczos_state(nv, torch.float64, "cpu")
		dia.lanczos_dia_sweep_step(bands, offs, q, q, state, torch.empty(nv, dtype=torch.complex128), out, 1e-8)
	with pytest.raises(ValueError):
		dia.lanczos_dia_sweep_step(bands, offs, q, q, dia.lanczos_state(nv + 1, torch.float64, "cpu"), out, out.clone(), 1e-8)
