"""bfloat16 operators in the port against the JAX package on the same numpy inputs: the plain
versions of the four kernels (bf16 storage, float32 sums) against JAX's Pallas kernels in interpret
mode, the Lanczos sweep on the flat and the halo-padded carry (``phys=True``) against JAX's, the
sweep on a sharded DIA operator over two gloo ranks against JAX's sharded operator, and ``hutch``
on injected probes. The rest of a bf16 step after pass A (the round pair's plain version) is held
bit for bit to the PyTorch tail it replaced, and a breakdown to JAX's zeros. The dtype policy of the CUDA wrappers (bf16 taken by the four kernels, float16
refused) is checked on the argument checks, which need no card.

Tolerances: a bf16 output within one bf16 ulp of the output's magnitude, ``2⁻⁸·max|ref|``; pass A's
float32 ``w`` and α within 1e-6 relative; α and β of a 12-step bf16 sweep within 1e-3 relative
(q is rounded to bf16 every step, in the same places in both packages); estimates within 1e-2."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import jax.numpy as jnp

import primate_tpu as pt
from benchmarks.matrices import block_random_spd
from primate_tpu.lanczos import lanczos_block_op as jax_lanczos_block_op
from primate_tpu.operators.sparse import BSROperator as JaxBSR
from primate_tpu.operators.sparse import DIAOperator as JaxDIA
from primate_tpu.ops.dia_pallas import HALO, LANE_TILE, dia_matmat, dia_matmat_t, dia_matmat_t_phys
from primate_tpu.ops.spmm_pallas import bsr_matmat
from primate_tpu.parallel import make_mesh as jax_mesh, shard_operator as jax_shard
from primate_tpu_torch import BSROperator, DIAOperator, MatrixFunction, hutch
from primate_tpu_torch.lanczos import lanczos_block_op
from primate_tpu_torch.operators import sparse as sparse_ops
from primate_tpu_torch.ops import _common, bsr, dia

torch.set_num_threads(1)
REPO = str(Path(__file__).resolve().parent.parent)
BF16 = torch.bfloat16
ULP = 2.0**-8  # one bf16 ulp of the output's magnitude: |Δ| ≤ 2⁻⁸·max|ref|
OFFSETS = [(-1, 0, 1), (-128, -17, -3, 0, 5, 16, 17, 128), tuple(range(-8, 9, 2))]


def _path_laplacian(n):
	return sps.diags([-np.ones(n - 1), 3.0 * np.ones(n), -np.ones(n - 1)], [-1, 0, 1]).tocsr()


def _bf(x):
	"""A numpy array rounded to bfloat16, as float32 (both packages get the same bf16 values)."""
	return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(BF16).float().numpy()


def _rel(got, want):
	got, want = (np.asarray(x, dtype=np.float64) for x in (got, want))
	return float(np.abs(got - want).max() / np.abs(want).max())


def _rademacher(n, nv, seed):
	return np.random.default_rng(seed).choice([-1.0, 1.0], size=(n, nv))


# -- the rounding of the stencil sum on the flat and the padded carry ----------------------------


def _spy_round_steps(monkeypatch, module):
	"""Count the calls of ``lanczos_dia_round_step`` through the name ``module`` calls it by."""
	calls = []
	real = module.lanczos_dia_round_step

	def spy(*args, **kwargs):
		calls.append(1)
		return real(*args, **kwargs)

	monkeypatch.setattr(module, "lanczos_dia_round_step", spy)
	return calls


@pytest.mark.parametrize("phys", [False, True], ids=["flat", "phys"])
def test_bf16_sweep_matches_jax_on_flat_and_padded_carry(phys, monkeypatch):
	"""``lanczos_block_op`` on a bf16 DIA operator against JAX's, tridiag(−1, 3, −1), n = 2048,
	8 Rademacher probes, deg 12, orth 0: α and β within 1e-3 relative. JAX's flat step rounds
	``matmat_t``'s output to bf16 before the β-axpy; its ``phys=True`` step takes
	``dia_matmat_t_phys``'s float32 output unrounded. Rounding in both layouts put the port's
	``phys=True`` 7.6e-3 (α) and 2.7e-3 (β) from JAX's. Each step goes through the operator's round
	step (pass A and the round pair on the card), once a step."""
	n, nv, deg = 2048, 8, 12
	L = _path_laplacian(n)
	V0 = _rademacher(n, nv, 0)
	calls = _spy_round_steps(monkeypatch, sparse_ops)
	got = lanczos_block_op(
		DIAOperator.from_scipy(L, dtype=BF16, device="cpu"), torch.from_numpy(V0).to(BF16), deg=deg, ncv=2, orth=0,
		return_basis=False, phys=phys,
	)
	want = jax_lanczos_block_op(
		JaxDIA.from_scipy(L, dtype=jnp.bfloat16), jnp.asarray(V0, dtype=jnp.bfloat16), deg=deg, ncv=2, orth=0,
		return_basis=False, phys=phys,
	)
	assert got.alphas.dtype == torch.float32
	assert len(calls) == deg
	assert _rel(got.alphas.numpy(), want.alphas) < 1e-3
	assert _rel(got.betas.numpy(), want.betas) < 1e-3


def _pytorch_tail(v, alpha_j, q_cur, done, residual_tol, rows):
	"""The bf16 step's tail as the sweep ran it in PyTorch before the round pair (orth 0): α, β,
	q_next, the done flags."""
	v.addcmul_(alpha_j[:, None], q_cur.to(v.dtype), value=-1)
	beta_next = torch.sqrt(dia.row_sq_norm(rows(v)))
	newly_done = beta_next < residual_tol
	alpha_out, beta_out = torch.where(done, 0.0, alpha_j), torch.where(done, 0.0, beta_next)
	q_next = v.div_(torch.where(beta_next > residual_tol, beta_next, torch.inf)[:, None]).to(q_cur.dtype)
	return alpha_out, beta_out, q_next, beta_next, done | newly_done


@pytest.mark.parametrize("phys", [False, True], ids=["flat", "phys"])
def test_round_plain_version_equals_the_pytorch_tail_bit_for_bit(phys):
	"""The round pair's plain version against the PyTorch tail it replaces, step by step on the same
	pass A output: α, β, q_next and the done flags bit for bit, on the flat and the padded carry,
	tridiag(−1, 3, −1), n = 2048, 8 probes, 12 steps; ``lanczos_dia_round_step`` (pass A and the pair)
	gives the same q_next."""
	n, nv, deg = 2048, 8, 12
	op = DIAOperator.from_scipy(_path_laplacian(n), dtype=BF16, device="cpu")
	spec = op.carry_spec(nv) if phys else dia.CarrySpec(n, 0, n)
	bands = op._carry_bands(spec if phys else None)
	X = torch.from_numpy(_rademacher(n, nv, 0).T.copy())
	q_cur = spec.pad((X / torch.linalg.vector_norm(X, dim=1, keepdim=True)).to(BF16))
	q_prev = torch.zeros_like(q_cur)
	tol = float(np.sqrt(n) * 1e-8)
	state = dia.lanczos_state(nv, torch.float32, "cpu")
	beta, done = torch.zeros(nv), torch.zeros(nv, dtype=torch.bool)
	for _ in range(deg):
		w, alpha = dia.lanczos_dia_step(bands, op.offsets_t, q_cur, q_prev, beta, spec, rounded=not phys)
		a_t, b_t, q_t, beta, done = _pytorch_tail(w.clone(), alpha, q_cur, done, tol, spec.rows)
		state.scal[dia.ALPHA] = alpha
		step_state = dia.LanczosState(state.scal.clone(), state.ticket)
		a_r, b_r = torch.empty(nv), torch.empty(nv)
		q_r = dia.lanczos_dia_round(w, q_cur, state, a_r, b_r, tol, spec)
		a_s, b_s = torch.empty(nv), torch.empty(nv)
		q_s = dia.lanczos_dia_round_step(bands, op.offsets_t, q_cur, q_prev, step_state, a_s, b_s, tol, spec, rounded=not phys)
		for got in ((a_r, b_r, q_r), (a_s, b_s, q_s)):
			assert all(torch.equal(g, t) for g, t in zip(got, (a_t, b_t, q_t)))
		assert torch.equal(state.scal[dia.BETA], beta) and torch.equal(state.scal[dia.DONE] != 0, done)
		assert torch.equal(step_state.scal, state.scal)
		q_prev, q_cur = q_cur, q_r
	assert q_cur.dtype == BF16 and not spec.zero_margins(q_cur.clone()).ne(q_cur).any()


def test_round_pair_finishing_mode_splits_as_its_kernels():
	"""On a row-sharded carry (``reduce`` and ``sums`` given) the round pair runs, on the CPU, as its kernels split
	it (``lanczos_round_pair_ref``): B1's Σ(w − α·q)² into ``sums[1]``, ``reduce``, then B2 the step's finish (the
	outputs, the divisors, β, the done flags) from the reduced sums beside ``q_next``. On a padded carry whose
	margins hold halo data, with a probe done before the step and one whose β' vanishes in it, that equals
	``lanczos_dia_round_ref`` on the same sums bit for bit (``q_next``, the outputs, the state), and leaves ``w``."""
	n, nv = 2048, 8
	rng = np.random.default_rng(19)
	spec = dia.carry_spec(n, 1, 2)
	q = spec.pad(torch.from_numpy(rng.normal(size=(nv, n)) / np.sqrt(n)).float()).to(BF16)
	q[:, : spec.lo] = torch.from_numpy(rng.normal(size=(nv, spec.lo))).to(BF16)  # a neighbour's rows
	alpha = torch.from_numpy(rng.uniform(1.0, 3.0, size=nv)).float()
	w = spec.pad(torch.from_numpy(rng.normal(size=(nv, n)) / np.sqrt(n)).float())
	spec.rows(w)[1] = alpha[1] * spec.rows(q)[1].float()  # probe 1: v = 0, β' = 0
	tol = float(np.sqrt(n) * 1e-6)
	states, outs = [], []
	for run in range(2):
		st = dia.lanczos_state(nv, torch.float32, "cpu")
		st.scal[dia.DIV_CUR], st.scal[dia.BETA], st.scal[dia.DONE, 0] = 1.5, 0.7, 1.0
		sums = torch.stack([alpha.clone(), torch.zeros(nv)])
		ab = torch.zeros((2, nv))
		w_in = w.clone()
		if run == 0:
			q_next = dia.lanczos_dia_round(w_in, q, st, ab[0], ab[1], tol, spec, reduce=lambda t: t, sums=sums)
			assert torch.equal(w_in, w)
		else:
			q_next = dia.lanczos_dia_round_ref(w_in, q, st, ab[0], ab[1], tol, spec, sums=sums)
		states.append(st.scal)
		outs.append((q_next, ab))
	assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1]) and torch.equal(states[0], states[1])
	assert outs[0][1][0, 0] == 0 and outs[0][1][1, 0] == 0 and states[0][dia.DONE, 1] == 1 and outs[0][1][1, 1] < tol
	assert not spec.zero_margins(outs[0][0].clone()).ne(outs[0][0]).any()


def _split_path(n, k):
	"""tridiag(−1, 3, −1) with row and column ``k`` cut loose (exact in bf16): ``e_k`` is an
	eigenvector, so a probe that starts there breaks down at the first step (β' = 0 exactly)."""
	off = -np.ones(n - 1)
	off[k - 1 : k + 1] = 0.0
	return sps.diags([off, 3.0 * np.ones(n), off], [-1, 0, 1]).tocsr()


@pytest.mark.parametrize("phys", [False, True], ids=["flat", "phys"])
def test_bf16_breakdown_emits_zeros_as_jax_does(phys):
	"""A probe that starts at an eigenvector breaks down at its first step: α = 3 then 0, β = 0 from
	that step on, in the port (through the round step: q_next = v / inf = 0) as in JAX; the other
	probes, Rademacher starts, match JAX's within 1e-3 relative."""
	n, nv, deg, k = 2048, 8, 12, 4
	A = _split_path(n, k)
	V0 = _rademacher(n, nv, 3)
	V0[:, 0] = 0.0
	V0[k, 0] = 1.0
	got = lanczos_block_op(
		DIAOperator.from_scipy(A, dtype=BF16, device="cpu"), torch.from_numpy(V0).to(BF16), deg=deg, ncv=2, orth=0,
		return_basis=False, phys=phys,
	)
	want = jax_lanczos_block_op(
		JaxDIA.from_scipy(A, dtype=jnp.bfloat16), jnp.asarray(V0, dtype=jnp.bfloat16), deg=deg, ncv=2, orth=0,
		return_basis=False, phys=phys,
	)
	a, b = got.alphas.numpy(), got.betas.numpy()
	wa, wb = np.asarray(want.alphas), np.asarray(want.betas)
	assert a[0, 0] == wa[0, 0] == 3.0
	assert not a[1:, 0].any() and not b[:, 0].any() and not wa[1:, 0].any() and not wb[:, 0].any()
	assert _rel(a[:, 1:], wa[:, 1:]) < 1e-3 and _rel(b[:, 1:], wb[:, 1:]) < 1e-3


def test_padded_carry_and_flat_carry_differ_only_by_the_rounding():
	"""On the padded carry the bf16 step is the unrounded stencil, on the flat one the rounded:
	pass A's plain version with ``rounded`` switched gives the same ``w`` on both layouts."""
	n, nv = 1001, 5
	rng = np.random.default_rng(7)
	offsets = (-3, 0, 1, 17)
	op = DIAOperator.from_numpy(_bf(rng.normal(size=(len(offsets), n))), offsets, (n, n), dtype=BF16, device="cpu")
	spec = op.carry_spec(nv)
	assert spec.lo % 64 == 0 and spec.ld % 64 == 0  # whole 128-byte lines of bf16
	q, qp = (torch.from_numpy(_bf(rng.normal(size=(nv, n)))).to(BF16) for _ in range(2))
	beta = torch.from_numpy(rng.uniform(0.5, 2.0, nv).astype(np.float32))
	for rounded in (True, False):
		v_flat, a_flat = dia.lanczos_dia_step(op.bands, op.offsets_t, q, qp, beta, rounded=rounded)
		v_pad, a_pad = dia.lanczos_dia_step(op._carry_bands(spec), op.offsets_t, spec.pad(q), spec.pad(qp), beta, spec, rounded=rounded)
		assert v_flat.dtype == torch.float32 and torch.equal(spec.rows(v_pad), v_flat)
		assert not v_pad[:, : spec.lo].any() and not v_pad[:, spec.lo + n :].any()
		np.testing.assert_allclose(a_pad.numpy(), a_flat.numpy(), rtol=1e-6)
	v_r, _ = dia.lanczos_dia_step(op.bands, op.offsets_t, q, qp, beta, rounded=True)
	v_u, _ = dia.lanczos_dia_step(op.bands, op.offsets_t, q, qp, beta, rounded=False)
	assert not torch.equal(v_r, v_u)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_rounding_switch_changes_nothing_in_float32_and_float64(dtype):
	n, nv = 700, 4
	rng = np.random.default_rng(8)
	offsets = (-5, 0, 2)
	bands = torch.from_numpy(rng.normal(size=(len(offsets), n))).to(dtype)
	offs = torch.tensor(offsets)
	q, qp = (torch.from_numpy(rng.normal(size=(nv, n))).to(dtype) for _ in range(2))
	beta = torch.from_numpy(rng.uniform(0.5, 2.0, nv)).to(dtype)
	(v1, a1), (v0, a0) = (dia.lanczos_dia_step(bands, offs, q, qp, beta, rounded=r) for r in (True, False))
	assert torch.equal(v1, v0) and torch.equal(a1, a0)


# -- the plain bf16 versions of the kernels against JAX's Pallas kernels (interpret) -------------


@pytest.mark.parametrize("offsets", OFFSETS, ids=["tridiagonal", "wide", "nine"])
def test_dia_stencil_t_plain_bf16_matches_jax_pallas(offsets):
	"""Probe-major: bf16 bands and block, float32 sums, one rounding to bf16."""
	n, nv = 1000, 6
	rng = np.random.default_rng(1)
	bands, X = _bf(rng.normal(size=(len(offsets), n))), _bf(rng.normal(size=(nv, n)))
	jop = JaxDIA(jnp.asarray(bands, dtype=jnp.bfloat16), offsets, (n, n))
	want = np.asarray(dia_matmat_t(jop, jnp.asarray(X, dtype=jnp.bfloat16), interpret=True), dtype=np.float32)
	got = dia.dia_stencil_t(torch.from_numpy(bands).to(BF16), torch.tensor(offsets), torch.from_numpy(X).to(BF16))
	assert got.dtype == BF16 and np.asarray(dia_matmat_t(jop, jnp.asarray(X, dtype=jnp.bfloat16), interpret=True)).dtype == jnp.bfloat16
	assert np.abs(got.float().numpy() - want).max() <= ULP * np.abs(want).max()


@pytest.mark.parametrize("offsets", OFFSETS[:2] + ["fem12"], ids=["tridiagonal", "wide", "fem12"])
def test_dia_stencil_plain_bf16_matches_jax_pallas(offsets):
	"""Node-major, k = 128 (the Pallas kernel's lane rule). ``fem12``: the FEM cell's operator at side 12
	(``fem_laplacian_3d(12)``: n = 1,728, offsets ±1, ±12, ±144, its bands exact in bf16)."""
	n, k = 900, 128
	rng = np.random.default_rng(2)
	if offsets == "fem12":
		from benchmarks.matrices import fem_laplacian_3d

		op = DIAOperator.from_scipy(fem_laplacian_3d(12), dtype=torch.float32, device="cpu")
		n, offsets, bands = op.shape[0], op.offsets, op.bands.numpy()
		assert sorted(offsets) == [-144, -12, -1, 0, 1, 12, 144] and np.array_equal(_bf(bands), bands)
		V = _bf(rng.normal(size=(n, k)))
		jop = JaxDIA(jnp.asarray(bands, dtype=jnp.bfloat16), offsets, (n, n))
		want = np.asarray(dia_matmat(jop, jnp.asarray(V, dtype=jnp.bfloat16), interpret=True), dtype=np.float32)
		got = dia.dia_stencil(torch.from_numpy(bands).to(BF16), torch.tensor(offsets), torch.from_numpy(V).to(BF16))
		assert got.dtype == BF16
		assert np.abs(got.float().numpy() - want).max() <= ULP * np.abs(want).max()
		return
	bands, V = _bf(rng.normal(size=(len(offsets), n))), _bf(rng.normal(size=(n, k)))
	jop = JaxDIA(jnp.asarray(bands, dtype=jnp.bfloat16), offsets, (n, n))
	want = np.asarray(dia_matmat(jop, jnp.asarray(V, dtype=jnp.bfloat16), interpret=True), dtype=np.float32)
	got = dia.dia_stencil(torch.from_numpy(bands).to(BF16), torch.tensor(offsets), torch.from_numpy(V).to(BF16))
	assert got.dtype == BF16
	assert np.abs(got.float().numpy() - want).max() <= ULP * np.abs(want).max()


@pytest.mark.parametrize("bs,k", [(8, 64), (4, 5)])
def test_bsr_spmm_plain_bf16_matches_jax_pallas(bs, k):
	"""bf16 tiles and V, float32 sums over each block row's tiles, one rounding."""
	n = 512
	A = block_random_spd(n=n, bs=8, density=0.04, seed=3)
	A.data = _bf(A.data)
	V = _bf(np.random.default_rng(4).normal(size=(n, k)))
	jop = JaxBSR.from_scipy(A, blocksize=(bs, bs), dtype=jnp.bfloat16)
	want = np.asarray(bsr_matmat(jop, jnp.asarray(V, dtype=jnp.bfloat16), interpret=True), dtype=np.float32)
	op = BSROperator.from_scipy(A, blocksize=(bs, bs), dtype=BF16, device="cpu")
	got = bsr.bsr_spmm(op.blocks, op.indptr, op.indices, torch.from_numpy(V).to(BF16), n)
	assert got.dtype == BF16 and op.blocks.dtype == BF16
	assert np.abs(got.float().numpy() - want).max() <= ULP * np.abs(want).max()
	np.testing.assert_array_equal(op.matmat(torch.from_numpy(V).to(BF16)).float().numpy(), got.float().numpy())


@pytest.mark.parametrize("offsets", OFFSETS[:2], ids=["tridiagonal", "wide"])
def test_pass_a_plain_bf16_matches_jax_phys_kernel(offsets):
	"""Pass A unrounded on the padded carry against JAX's ``dia_matmat_t_phys`` (float32 out for a
	bf16 carry) followed by the β-axpy and α in float32: within 1e-6 relative. Rounded on the flat
	carry against ``dia_matmat_t`` (bf16 out) and the same axpy."""
	n, nv = 1001, 5
	rng = np.random.default_rng(5)
	bands, q, qp = _bf(rng.normal(size=(len(offsets), n))), _bf(rng.normal(size=(nv, n))), _bf(rng.normal(size=(nv, n)))
	beta = rng.uniform(0.5, 2.0, nv).astype(np.float32)
	n_dom = -(-n // LANE_TILE) * LANE_TILE
	bands_dom = np.zeros((len(offsets), n_dom), np.float32)
	bands_dom[:, :n] = bands
	Xp = np.zeros((nv, n_dom + 2 * HALO), np.float32)
	Xp[:, HALO : HALO + n] = q
	Aq = np.asarray(dia_matmat_t_phys(jnp.asarray(bands_dom, jnp.bfloat16), jnp.asarray(Xp, jnp.bfloat16), offsets, interpret=True))
	assert Aq.dtype == np.float32
	jop = JaxDIA(jnp.asarray(bands, dtype=jnp.bfloat16), offsets, (n, n))
	Aq_flat = np.asarray(dia_matmat_t(jop, jnp.asarray(q, dtype=jnp.bfloat16), interpret=True), dtype=np.float32)

	op = DIAOperator.from_numpy(bands, offsets, (n, n), dtype=BF16, device="cpu")
	spec = op.carry_spec(nv)
	tq, tqp, tb = torch.from_numpy(q).to(BF16), torch.from_numpy(qp).to(BF16), torch.from_numpy(beta)
	cases = (
		(Aq[:, HALO : HALO + n], dia.lanczos_dia_step(op._carry_bands(spec), op.offsets_t, spec.pad(tq), spec.pad(tqp), tb, spec, rounded=False)),
		(Aq_flat, dia.lanczos_dia_step(op.bands, op.offsets_t, tq, tqp, tb, rounded=True)),
	)
	for i, (stencil, (v, alpha)) in enumerate(cases):
		w_want = stencil - beta[:, None] * qp
		alpha_want = np.sum(w_want.astype(np.float64) * q, axis=1)
		w = spec.rows(v) if i == 0 else v
		assert v.dtype == torch.float32 and alpha.dtype == torch.float32
		np.testing.assert_allclose(w.numpy(), w_want, rtol=0, atol=1e-6 * np.abs(w_want).max())
		np.testing.assert_allclose(alpha.numpy(), alpha_want, rtol=0, atol=1e-6 * np.abs(alpha_want).max())


# -- the wrappers' dtype policy on a CUDA device (argument checks only: no card needed) ----------


@pytest.mark.parametrize("name", ["dia_stencil_t", "dia_stencil", "lanczos_dia_step", "bsr_spmm"])
def test_the_four_kernels_take_bf16_and_refuse_float16(name):
	cuda = torch.device("cuda", 0)
	kw = dict(complex_ok=name != "lanczos_dia_step", bf16_ok=True)
	_common.check_cuda(name, BF16, cuda, **kw)
	with pytest.raises(TypeError, match="float16"):
		_common.check_cuda(name, torch.float16, cuda, **kw)


def test_round_pair_takes_bf16_only_and_refuses_float16():
	"""The round pair exists for bf16 carries alone (a float32/float64 sweep runs pass B); its state,
	outputs and sums are in the accumulation dtype."""
	cuda = torch.device("cuda", 0)
	kw = dict(bf16_only=True, acc_keys=("w",))
	_common.check_cuda("lanczos_dia_round", BF16, cuda, **kw)
	for dtype in (torch.float32, torch.float64, torch.float16):
		with pytest.raises(TypeError, match="takes bfloat16; got"):
			_common.check_cuda("lanczos_dia_round", dtype, cuda, **kw)
	assert _common.LAUNCHES["lanczos_dia_round"] == 0 and "lanczos_dia_round" in _common.BF16_LAUNCHES


def test_pass_b_refuses_bf16_and_bf16_sums_in_float32():
	"""Pass B and the advance have no bf16 instantiation (the bf16 sweep runs pass A and a PyTorch
	tail); a bf16 kernel's sums, pass A's w and α, are float32."""
	cuda = torch.device("cuda", 0)
	with pytest.raises(TypeError, match="float32, float64; got torch.bfloat16"):
		_common.check_cuda("lanczos_dia_sweep_step", BF16, cuda)
	assert _common.SUFFIX[BF16] == "bf16" and torch.float16 not in _common.SUFFIX
	assert _common.acc_dtype(BF16) == torch.float32


# -- estimators on injected probes ---------------------------------------------------------------


def _sampler(seed):
	rng = np.random.default_rng(seed)
	return lambda size: rng.choice([-1.0, 1.0], size=size)


def test_bf16_hutch_logdet_on_dia_matches_jax():
	"""JAX's full-bf16 SLQ (``benchmarks/RESULTS.md``): a bf16 DIA operator and
	``MatrixFunction(..., dtype=bfloat16)``, log, deg 20, orth 0, on the same numpy probes: within
	1e-2 of JAX's estimate and within 5% of the exact logdet."""
	n = 4096
	L = _path_laplacian(n)
	kw = dict(batch=16, converge="count", count=32)
	M = MatrixFunction(DIAOperator.from_scipy(L, dtype=BF16, device="cpu"), "log", deg=20, orth=0, dtype=BF16)
	got = hutch(M, pdf=_sampler(11), **kw)
	want = float(pt.hutch(pt.MatrixFunction(JaxDIA.from_scipy(L, dtype=jnp.bfloat16), "log", deg=20, orth=0, dtype=jnp.bfloat16), pdf=_sampler(11), **kw))
	exact = float(np.sum(np.log(3.0 - 2.0 * np.cos(np.arange(1, n + 1) * np.pi / (n + 1)))))
	assert abs(got - want) / abs(want) < 1e-2
	assert abs(got - exact) / abs(exact) < 0.05


def test_bf16_hutch_trace_on_bsr_matches_jax():
	"""Girard-Hutchinson trace of a bf16 BSR operator (``block_random_spd``'s 8 × 8 tiles, the BSR
	cell's generator) on the same numpy probes: within 1e-2 of JAX's estimate and within 5% of the
	trace of the bf16 matrix."""
	n = 1024
	A = block_random_spd(n=n, bs=8, density=0.04, seed=6)
	A.data = _bf(A.data)
	kw = dict(batch=16, converge="count", count=64)
	got = hutch(BSROperator.from_scipy(A, blocksize=(8, 8), dtype=BF16, device="cpu"), pdf=_sampler(12), **kw)
	want = float(pt.hutch(JaxBSR.from_scipy(A, blocksize=(8, 8), dtype=jnp.bfloat16), pdf=_sampler(12), **kw))
	tr = float(A.diagonal().sum())
	assert abs(got - want) / abs(want) < 1e-2
	assert abs(got - tr) / tr < 0.05


# -- the sharded bf16 sweep over two gloo ranks ------------------------------------------------------

# The ranks meet through a file store in tmp_path (no probed TCP port that another process could take
# first). The sharded operator and its mesh hold gloo process groups: a worker frees them, meets the
# other rank at a barrier and destroys the default group before it exits. A group left to the
# interpreter's exit aborted the process now and then ("terminate called without an active exception").
_WORKER = r'''
import gc
import sys
from datetime import timedelta

rank, store, repo, path = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
sys.path.insert(0, repo)
import numpy as np
import scipy.sparse as sps
import torch

torch.set_num_threads(1)
import primate_tpu_torch as ptt
from primate_tpu_torch.lanczos import lanczos_block_op
from primate_tpu_torch.parallel import initialize_distributed, make_mesh, shard_operator


def sweep():
	V0 = np.load(path)["V0"]
	n = V0.shape[0]
	L = sps.diags([-np.ones(n - 1), 3.0 * np.ones(n), -np.ones(n - 1)], [-1, 0, 1]).tocsr()
	op = shard_operator(ptt.DIAOperator.from_scipy(L, dtype=torch.bfloat16, device="cpu"), make_mesh((2, 1), device_type="cpu"))
	out = lanczos_block_op(op, torch.from_numpy(V0).to(torch.bfloat16), deg=12, ncv=2, orth=0, return_basis=False)
	np.savez(path.replace(".npz", f".{rank}.npz"), alphas=out.alphas.numpy(), betas=out.betas.numpy(), dtype=str(op.dtype))


initialize_distributed("gloo", init_method=f"file://{store}", world_size=2, rank=rank, timeout=timedelta(seconds=90))
sweep()
gc.collect()
torch.distributed.barrier()
torch.distributed.destroy_process_group()
'''


def test_sharded_bf16_sweep_on_two_gloo_ranks_matches_jax_sharded(tmp_path):
	"""The bf16 sweep on ``ShardedDIAOperator`` (its round step: pass A on the padded carry after the
	halo exchange, the stencil rounded as JAX's sharded apply rounds it, α all-reduced, then the round
	pair's plain version with Σv² all-reduced) over two gloo ranks: both
	ranks bit for bit alike, α and β within 1e-3 relative of JAX's sharded bf16 operator on its
	8-device mesh and of the unsharded port."""
	n, nv = 2048, 8
	V0 = _rademacher(n, nv, 0)
	path = str(tmp_path / "V0.npz")
	np.savez(path, V0=V0)
	script = tmp_path / "worker.py"
	script.write_text(_WORKER)
	store = str(tmp_path / "store")
	env = {**os.environ, "OMP_NUM_THREADS": "1"}
	procs = [subprocess.Popen([sys.executable, str(script), str(r), store, REPO, path], env=env, stderr=subprocess.PIPE, text=True) for r in range(2)]
	try:
		for p in procs:
			_, err = p.communicate(timeout=240)
			assert p.returncode == 0, err[-3000:]
	finally:
		for p in procs:
			if p.poll() is None:
				p.kill()
	r0, r1 = (np.load(path.replace(".npz", f".{r}.npz")) for r in range(2))
	assert str(r0["dtype"]) == "torch.bfloat16"
	assert np.array_equal(r0["alphas"], r1["alphas"]) and np.array_equal(r0["betas"], r1["betas"])
	jop = jax_shard(JaxDIA.from_scipy(_path_laplacian(n), dtype=jnp.bfloat16), jax_mesh((8, 1), ("op", "probe")))
	want = jax_lanczos_block_op(jop, jnp.asarray(V0, dtype=jnp.bfloat16), deg=12, ncv=2, orth=0, return_basis=False)
	assert _rel(r0["alphas"], want.alphas) < 1e-3 and _rel(r0["betas"], want.betas) < 1e-3
	flat = lanczos_block_op(
		DIAOperator.from_scipy(_path_laplacian(n), dtype=BF16, device="cpu"), torch.from_numpy(V0).to(BF16), deg=12, ncv=2, orth=0,
		return_basis=False,
	)
	assert _rel(r0["alphas"], flat.alphas.numpy()) < 1e-3 and _rel(r0["betas"], flat.betas.numpy()) < 1e-3
