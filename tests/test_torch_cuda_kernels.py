"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips without a CUDA device. Imports no JAX (the
card's machine has none). Run on the card with
``python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_cuda_kernels.py``.
"""

import math
import os
import sys

import numpy as np
import pytest
import scipy.sparse as sps
import torch

from primate_tpu_torch import BSROperator, CSROperator, DIAOperator, MatrixFunction, hutch, lanczos_block_op, xtrace
from primate_tpu_torch.operators.base import FunctionOperator, LinearOperator
from primate_tpu_torch.ops import _common, bsr, cgs, dia
from primate_tpu_torch.ops import autograd as ptt_autograd
from primate_tpu_torch.random import real_dtype

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

torch.set_num_threads(1)
pytestmark = pytest.mark.cuda

# (nv, n, offsets[, lead]). After the first three, for the probe-major stencil: a probe
# count past a group of 4, n not a multiple of 4 and then a multiple, with offsets that are
# (±128) and are not (±129, 10,001) whole 16-byte vectors; n smaller than the offsets, with offsets of
# n and past it; more diagonals than one chunk of band slots (8); a lone main diagonal;
# all but the main diagonal at n or past it; and x a contiguous block that starts one
# element into its buffer (`lead`), which takes the kernel's scalar path.
SHAPES = [
	(64, 20_000, (-1, 0, 1)), (13, 3001, (-200, -7, 0, 7, 200)), (1, 5, (-9, 0, 2)),
	(65, 12_001, (-10_001, -129, -128, -3, 0, 1, 128, 129, 10_001)),
	(65, 12_000, (-10_001, -129, -128, -3, 0, 1, 128, 129, 10_000)),
	(7, 100, (-150, -100, -1, 0, 1, 99, 100, 300)),
	(64, 30_001, tuple(range(-8, 9))),
	(1, 12_000, (0,)),
	(64, 9, (-9, 0, 9, 40)),
	(13, 12_000, (-10_000, -7, 0, 3, 10_000), 1),
]
# Stencil: max-abs error over max|out|. α: relative, since the summation orders differ.
TOL = {torch.float32: (1e-5, 1e-4), torch.float64: (1e-12, 1e-10)}


@pytest.fixture
def cuda():
	if not torch.cuda.is_available():
		pytest.skip("needs a CUDA device")
	return torch.device("cuda", 0)


def _inputs(dev, nv, n, offsets, dtype, lead=0, seed=0):
	g = torch.Generator(device=dev)
	g.manual_seed(seed)
	bands = torch.rand((len(offsets), n), generator=g, device=dev, dtype=dtype) + 0.5
	offs = torch.tensor(offsets, dtype=torch.int64, device=dev)
	unit = lambda X: X / torch.linalg.vector_norm(X, dim=1, keepdim=True)  # noqa: E731
	x = torch.randn(lead + nv * n, generator=g, device=dev, dtype=dtype)[lead:].view(nv, n)
	q_cur = unit(torch.randn((nv, n), generator=g, device=dev, dtype=dtype))
	q_prev = unit(torch.randn((nv, n), generator=g, device=dev, dtype=dtype))
	beta = torch.rand(nv, generator=g, device=dev, dtype=dtype) + 0.5
	return bands, offs, x, q_cur, q_prev, beta


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", SHAPES)
def test_kernels_match_plain_versions(cuda, shape, dtype):
	tol_s, tol_a = TOL[dtype]
	bands, offs, x, q_cur, q_prev, beta = _inputs(cuda, *shape[:3], dtype, *shape[3:])
	scalar = not _common.vector_ok(x.shape[1], x.element_size(), x)
	assert x.is_contiguous() and (scalar or len(shape) == 3)  # a block with a lead is misaligned
	before, scalar_before = dict(dia.LAUNCHES), _common.SCALAR_LAUNCHES["dia_stencil_t"]
	got, want = dia.dia_stencil_t(bands, offs, x), dia.dia_stencil_t_ref(bands, offs, x)
	v, alpha = dia.lanczos_dia_step(bands, offs, q_cur, q_prev, beta)
	v_ref, alpha_ref = dia.lanczos_dia_step_ref(bands, offs, q_cur, q_prev, beta)
	torch.cuda.synchronize()
	assert dia.LAUNCHES["dia_stencil_t"] == before["dia_stencil_t"] + 1
	assert _common.SCALAR_LAUNCHES["dia_stencil_t"] == scalar_before + scalar
	assert dia.LAUNCHES["lanczos_dia_step"] == before["lanczos_dia_step"] + 1
	assert float((got - want).abs().max()) <= tol_s * float(want.abs().max())
	assert float((v - v_ref).abs().max()) <= tol_s * float(v_ref.abs().max())
	assert float(((alpha - alpha_ref).abs() / alpha_ref.abs()).max()) <= tol_a


STEP_SHAPES = [(64, 500_000, (-1, 0, 1)), (13, 3001, (-200, -7, 0, 7, 200))]


def _step_state(dev, nv, dtype, g):
	"""A state in the middle of a sweep: divisors and β away from 1, one probe done."""
	state = dia.lanczos_state(nv, dtype, dev)
	state.scal[dia.DIV_CUR] = torch.rand(nv, generator=g, device=dev, dtype=dtype) + 0.5
	state.scal[dia.DIV_PREV] = torch.rand(nv, generator=g, device=dev, dtype=dtype) + 0.5
	state.scal[dia.BETA] = torch.rand(nv, generator=g, device=dev, dtype=dtype) + 0.5
	state.scal[dia.DONE, 0] = 1.0
	return state


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", STEP_SHAPES)
def test_whole_step_matches_its_plain_version(cuda, shape, dtype):
	"""Three steps of the two step kernels against the plain whole step, from the
	same residual blocks and state: v, α, β and the advanced state."""
	tol_v, tol_a = TOL[dtype]
	nv, n, offsets = shape
	bands, offs, _, v_cur, v_prev, _ = _inputs(cuda, nv, n, offsets, dtype, seed=3)
	g = torch.Generator(device=cuda)
	g.manual_seed(4)
	states = [_step_state(cuda, nv, dtype, g)]
	states.append(dia.LanczosState(states[0].scal.clone(), torch.zeros(1, dtype=torch.int32, device=cuda)))
	blocks = [(v_cur, v_prev), (v_cur.clone(), v_prev.clone())]
	for _ in range(3):
		outs = []
		for i, run in enumerate((dia.lanczos_dia_sweep_step, None)):
			a, b = torch.empty(nv, dtype=dtype, device=cuda), torch.empty(nv, dtype=dtype, device=cuda)
			vc, vp = blocks[i]
			if run is None:
				v = dia.lanczos_sweep_step_ref(lambda q: dia.dia_stencil_t_ref(bands, offs, q), vc, vp, states[i], a, b, 1e-8)
			else:
				before = (dia.LAUNCHES["lanczos_dia_step"], dia.LAUNCHES["lanczos_dia_residual"])
				v = run(bands, offs, vc, vp, states[i], a, b, 1e-8)
				assert (dia.LAUNCHES["lanczos_dia_step"], dia.LAUNCHES["lanczos_dia_residual"]) == (before[0] + 1, before[1] + 1)
			blocks[i] = (v, vc)
			outs.append((v, a, b))
		torch.cuda.synchronize()
		(v, a, b), (v_ref, a_ref, b_ref) = outs
		assert float((v - v_ref).abs().max()) <= tol_v * float(v_ref.abs().max())
		assert a[0] == 0 and b[0] == 0  # probe 0 was done before the first step
		assert float(((a - a_ref).abs() / a_ref.abs().clamp_min(1e-30))[1:].max()) <= tol_a
		assert float(((b - b_ref).abs() / b_ref.abs().clamp_min(1e-30))[1:].max()) <= tol_a
		rows = [dia.DIV_CUR, dia.DIV_PREV, dia.BETA, dia.ALPHA]
		rel = (states[0].scal[rows] - states[1].scal[rows]).abs() / states[1].scal[rows].abs()
		assert float(rel[:, 1:].max()) <= tol_a
		assert torch.equal(states[0].scal[dia.DONE], states[1].scal[dia.DONE])
		assert int(states[0].ticket) == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_whole_step_breakdown_on_the_card(cuda, dtype):
	"""A probe in a 3-dimensional invariant subspace breaks down at step 3: on the
	card its α and β are exactly zero afterwards, and the sweep agrees with the plain one."""
	n = 50
	off = -0.5 * np.ones(n - 1)
	off[2] = 0.0
	A = sps.diags([off, np.linspace(1.0, 4.0, n), off], [-1, 0, 1]).tocsr()
	V0 = np.random.default_rng(1).normal(size=(n, 4))
	V0[3:, 0] = 0.0
	rtol = 1e-5 if dtype == torch.float32 else 1e-8  # float32 leaves β₃ at its round-off, about 1e-6
	kw = dict(deg=8, ncv=2, orth=0, rtol=rtol)
	got = lanczos_block_op(DIAOperator.from_scipy(A, dtype=dtype, device=cuda), torch.tensor(V0, dtype=dtype, device=cuda), **kw)
	want = lanczos_block_op(DIAOperator.from_scipy(A, dtype=dtype, device="cpu"), torch.tensor(V0, dtype=dtype), **kw)
	a, b = got.alphas.cpu(), got.betas.cpu()
	assert float(b[2, 0]) < 1e-5 and bool(torch.all(a[3:, 0] == 0)) and bool(torch.all(b[3:, 0] == 0))
	tol_a = TOL[dtype][1]
	torch.testing.assert_close(a, want.alphas, rtol=tol_a, atol=tol_a)
	torch.testing.assert_close(b, want.betas, rtol=tol_a, atol=tol_a)


class _TailDIA(DIAOperator):
	"""A DIA operator whose sweep step is the generic PyTorch one around the stencil kernel."""

	lanczos_sweep_step = LinearOperator.lanczos_sweep_step


def test_flagship_fused_step_matches_the_pytorch_tail(cuda):
	"""The flagship's sweep (n = 500,000, deg 20, 64 probes, float32) through the two
	step kernels against the same sweep with the step's tail in PyTorch: the same
	probes, α and β to 1e-5 relative."""
	n = 500_000
	L = sps.diags([-np.ones(n - 1), 3.0 * np.ones(n), -np.ones(n - 1)], [-1, 0, 1]).tocsr()
	op = DIAOperator.from_scipy(L, dtype=torch.float32, device=cuda)
	tail = _TailDIA(op.bands, op.offsets, op.shape)
	g = torch.Generator(device=cuda)
	g.manual_seed(0)
	V0 = (torch.randint(0, 2, (64, n), generator=g, device=cuda, dtype=torch.float32) * 2 - 1).T
	dia.reset_launches()
	got = lanczos_block_op(op, V0, deg=20, ncv=2, orth=0)
	assert dia.LAUNCHES["lanczos_dia_step"] == dia.LAUNCHES["lanczos_dia_residual"] == 20
	want = lanczos_block_op(tail, V0, deg=20, ncv=2, orth=0)
	assert dia.LAUNCHES["lanczos_dia_step"] == 20 and dia.LAUNCHES["dia_stencil_t"] == 20
	torch.testing.assert_close(got.alphas, want.alphas, rtol=1e-5, atol=0)
	torch.testing.assert_close(got.betas, want.betas, rtol=1e-5, atol=0)


# (nv, n, offsets) on the padded carry: n not a multiple of 4 (a last own vector that runs into the
# margin), offsets inside and past the passes' 16-row staging up to ±128, nv past a probe group.
PADDED_SHAPES = [(64, 20_001, (-1, 0, 1)), (13, 3001, (-128, -17, -16, -3, 0, 16, 17, 128)), (5, 1001, (-40, -7, 0, 7, 40))]


@pytest.mark.parametrize("halo", [False, True], ids=["zero_margins", "halo_margins"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", PADDED_SHAPES)
def test_step_kernels_on_a_padded_carry(cuda, shape, dtype, halo):
	"""The step kernels on the padded carry (``CarrySpec``), three whole steps from a mid-sweep state
	against the plain step on the same carry: fused (two launches) and in the finishing mode with an
	identity ``reduce`` (pass A and pass B, two launches a step too: each step's finish is left pending
	and runs in the next step's pass A, the last one in ``lanczos_dia_finish``, the advance kernel, so
	a step's outputs are checked one step later and the state after the finish), on their vector paths.
	With ``halo_margins`` the margins of the first carries hold data, as after a halo exchange: the
	kernels read it as the neighbours' rows. The new carries' margins are exactly zero; pass A alone too."""
	tol_v, tol_a = TOL[dtype]
	nv, n, offsets = shape
	g = torch.Generator(device=cuda)
	g.manual_seed(12)
	spec = dia.carry_spec(n, max(abs(o) for o in offsets), torch.empty((), dtype=dtype).element_size())
	bands = spec.pad(torch.rand((len(offsets), n), generator=g, device=cuda, dtype=dtype) + 0.5)
	offs = torch.tensor(offsets, dtype=torch.int64, device=cuda)

	def carry():  # unit rows, as a sweep's Lanczos vectors; halo data on their scale
		X = torch.randn((nv, n), generator=g, device=cuda, dtype=dtype)
		X = spec.pad(X / torch.linalg.vector_norm(X, dim=1, keepdim=True))
		if halo:
			X[:, : spec.lo] = torch.randn((nv, spec.lo), generator=g, device=cuda, dtype=dtype) / n**0.5
			X[:, spec.lo + n :] = torch.randn((nv, spec.ld - spec.lo - n), generator=g, device=cuda, dtype=dtype) / n**0.5
		return X

	v0, vp0 = carry(), carry()
	apply_ref = lambda q: dia.dia_stencil_t_ref(bands, offs, q)  # noqa: E731
	margins = lambda X: torch.cat([X[:, : spec.lo], X[:, spec.lo + n :]], dim=1)  # noqa: E731
	def check_outputs(got, want):
		(a, b), (a_ref, b_ref) = got, want
		assert a[0] == 0 and b[0] == 0  # probe 0 was done before the first step
		assert float(((a - a_ref).abs() / a_ref.abs().clamp_min(1e-30))[1:].max()) <= tol_a
		assert float(((b - b_ref).abs() / b_ref.abs().clamp_min(1e-30))[1:].max()) <= tol_a

	def check_states(got, want):
		rows = [dia.DIV_CUR, dia.DIV_PREV, dia.BETA, dia.ALPHA]
		rel = (got.scal[rows] - want.scal[rows]).abs() / want.scal[rows].abs()
		assert float(rel[:, 1:].max()) <= tol_a
		assert torch.equal(got.scal[dia.DONE], want.scal[dia.DONE])

	for reduce in (None, lambda t: t):
		state = _step_state(cuda, nv, dtype, g)
		states = [state, dia.LanczosState(state.scal.clone(), torch.zeros(1, dtype=torch.int32, device=cuda))]
		blocks = [(v0, vp0), (v0.clone(), vp0.clone())]
		held = None  # the finishing mode's outputs of the step before, written by this step's pass A
		for _ in range(3):
			outs = []
			for i in range(2):
				a, b = torch.empty(nv, dtype=dtype, device=cuda), torch.empty(nv, dtype=dtype, device=cuda)
				vc, vp = blocks[i]
				if i == 1:
					v = dia.lanczos_sweep_step_ref(apply_ref, vc, vp, states[1], a, b, 1e-8, spec=spec)
				else:
					before, scalar = dict(dia.LAUNCHES), dict(_common.SCALAR_LAUNCHES)
					v = dia.lanczos_dia_sweep_step(bands, offs, vc, vp, states[0], a, b, 1e-8, spec, reduce)
					steps = {k: dia.LAUNCHES[k] - before[k] for k in ("lanczos_dia_step", "lanczos_dia_residual", "lanczos_dia_advance")}
					assert steps == {"lanczos_dia_step": 1, "lanczos_dia_residual": 1, "lanczos_dia_advance": 0}
					assert _common.SCALAR_LAUNCHES == scalar  # ld and lo are whole vectors
					assert len(states[0].pending) == int(reduce is not None)
				blocks[i] = (v, vc)
				outs.append((v, a, b))
			torch.cuda.synchronize()
			(v, a, b), (v_ref, a_ref, b_ref) = outs
			assert not margins(v).any()
			assert float((v - v_ref).abs().max()) <= tol_v * float(v_ref.abs().max())
			if reduce is None:
				check_outputs((a, b), (a_ref, b_ref))
				check_states(states[0], states[1])
			else:
				if held is not None:
					check_outputs(*held)
				held = ((a, b), (a_ref, b_ref))
		if reduce is not None:
			before = dia.LAUNCHES["lanczos_dia_advance"]
			dia.lanczos_dia_finish(states[0])
			torch.cuda.synchronize()
			assert dia.LAUNCHES["lanczos_dia_advance"] == before + 1 and not states[0].pending
			check_outputs(*held)
			check_states(states[0], states[1])
	beta = torch.rand(nv, generator=g, device=cuda, dtype=dtype) + 0.5
	v, alpha = dia.lanczos_dia_step(bands, offs, v0, vp0, beta, spec)
	v_ref, alpha_ref = dia.lanczos_dia_step_ref(bands, offs, v0, vp0, beta, spec)
	torch.cuda.synchronize()
	assert not margins(v).any()
	assert float((v - v_ref).abs().max()) <= tol_v * float(v_ref.abs().max())
	assert float(((alpha - alpha_ref).abs() / alpha_ref.abs()).max()) <= tol_a


def test_padded_phys_sweep_on_the_card_matches_the_flat_one(cuda):
	"""``lanczos_block_op(phys=True)`` on the card (the step kernels on the padded carry) against
	the flat sweep, float64, orth 0 and 5, with the basis."""
	n, nv = 20_001, 8
	L = sps.diags([-np.ones(n - 1), 3.0 * np.ones(n), -np.ones(n - 1)], [-1, 0, 1]).tocsr()
	op = DIAOperator.from_scipy(L, dtype=torch.float64, device=cuda)
	V0 = torch.from_numpy(np.random.default_rng(5).normal(size=(n, nv))).to(cuda)
	for orth in (0, 5):
		got, want = (lanczos_block_op(op, V0, deg=20, ncv=20, orth=orth, phys=p) for p in (True, False))
		for g, w in ((got.alphas, want.alphas), (got.betas, want.betas), (got.Q, want.Q)):
			assert float((g - w).abs().max()) <= 1e-10


def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
	bands, offs, x, q_cur, q_prev, beta = _inputs(cuda, 4, 100, (-1, 0, 1), torch.float32)
	with pytest.raises(TypeError):
		dia.dia_stencil_t(bands, offs, x.double())
	with pytest.raises(TypeError):  # float16: no kernel takes it (bfloat16 does)
		dia.dia_stencil_t(bands.half(), offs, x.half())
	c64 = torch.complex64
	with pytest.raises(TypeError):  # a complex carry's β is real (the real accumulation dtype)
		dia.lanczos_dia_step(bands.to(c64), offs, q_cur.to(c64), q_prev.to(c64), beta.to(c64))
	with pytest.raises(TypeError):
		dia.dia_stencil_t(bands.to(c64), offs, x)
	with pytest.raises(ValueError, match="contiguous"):
		dia.dia_stencil_t(bands, offs, torch.randn((100, 4), device=cuda).T)
	with pytest.raises(ValueError):
		dia.lanczos_dia_step(bands, offs.cpu(), q_cur, q_prev, beta)


@pytest.mark.parametrize("orth", [0, 5])
def test_slq_on_the_card_matches_the_cpu_port(cuda, orth):
	"""The whole slice, f64, the same numpy probes on both devices: without re-orthogonalisation passes
	A and B a step, at ``orth = 5`` pass A and the CGS window's chain a step."""
	n = 5000
	L = sps.diags([-np.ones(n - 1), 3.0 * np.ones(n), -np.ones(n - 1)], [-1, 0, 1]).tocsr()

	def sampler():
		rng = np.random.default_rng(3)
		return lambda size: rng.choice([-1.0, 1.0], size=size)

	kw = dict(fun="log", deg=20, orth=orth)
	dia.reset_launches()
	got = hutch(MatrixFunction(DIAOperator.from_scipy(L, device=cuda), **kw), batch=16, converge="count", count=32, pdf=sampler())
	steps = 20 * 2
	assert dia.LAUNCHES["lanczos_dia_step"] == steps
	assert (dia.LAUNCHES["lanczos_dia_residual"], dia.LAUNCHES["cgs_window"]) == ((steps, 0) if orth == 0 else (0, steps))
	assert _common.SCALAR_LAUNCHES["cgs_window"] == 0
	want = hutch(MatrixFunction(DIAOperator.from_scipy(L, device="cpu"), **kw), batch=16, converge="count", count=32, pdf=sampler())
	np.testing.assert_allclose(got, want, rtol=1e-10)


# Awkward shapes of the sparse kernels: non-square and small tiles, an empty block
# row, n not a multiple of bm, one column, k past one block of threads; DIA offsets
# of ±10,000 on a short n. Tolerance: max-abs error over max|out|.
SPARSE_TOL = {torch.float32: 1e-5, torch.float64: 1e-12, torch.complex64: 1e-5, torch.complex128: 1e-12}


def _bsr_arrays(dev, dtype, bm, bn, n=1001, empty_row=3, seed=0):
	A = sps.random(n, n, density=0.01, random_state=np.random.default_rng(seed), format="csr").toarray()
	A[empty_row * bm : (empty_row + 1) * bm] = 0.0
	A = sps.csr_matrix(A)
	A.resize((-(-n // bm) * bm, -(-n // bn) * bn))
	S = A.tobsr(blocksize=(bm, bn))
	assert np.diff(S.indptr)[empty_row] == 0
	as_dev = lambda x, dt: torch.tensor(x, dtype=dt, device=dev)  # noqa: E731
	return as_dev(S.data, dtype), as_dev(S.indptr, torch.int64), as_dev(S.indices, torch.int64), n


def _close_rel(got, want, dtype):
	torch.cuda.synchronize()
	assert float((got - want).abs().max()) <= SPARSE_TOL[dtype] * float(want.abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("k", [1, 3, 64, 65, 130, 720, 1500])
@pytest.mark.parametrize("tile", [(8, 16), (4, 4), (8, 8)])
def test_bsr_spmm_matches_plain_version(cuda, tile, k, dtype):
	blocks, indptr, indices, n = _bsr_arrays(cuda, dtype, *tile)
	g = torch.Generator(device=cuda)
	g.manual_seed(k)
	V = torch.randn((n, k), generator=g, device=cuda, dtype=dtype)
	before = dia.LAUNCHES["bsr_spmm"]
	got = bsr.bsr_spmm(blocks, indptr, indices, V, n)
	assert dia.LAUNCHES["bsr_spmm"] == before + 1
	want = bsr.bsr_spmm_ref(blocks, indptr, indices, V, n)
	_close_rel(got, want, dtype)
	assert float(got[3 * tile[0] : 4 * tile[0]].abs().max()) == 0.0  # the empty block row


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("k", [64, 65])
def test_bsr_spmm_hub_row_and_empty_rows(cuda, k, dtype):
	"""A block row of 5,000 tiles among short and empty ones (8x8 tiles, 6,000 block rows)."""
	rng = np.random.default_rng(7)
	n_brow, bm = 6000, 8
	counts = rng.integers(0, 4, n_brow)
	counts[::7] = 0
	counts[5] = 5000
	cols = [np.sort(rng.choice(n_brow, c, replace=False)) for c in counts]
	indptr = np.r_[0, np.cumsum(counts)]
	blocks = torch.tensor(rng.normal(size=(int(indptr[-1]), bm, bm)), dtype=dtype, device=cuda)
	indptr_t = torch.tensor(indptr, dtype=torch.int64, device=cuda)
	indices = torch.tensor(np.concatenate(cols), dtype=torch.int64, device=cuda)
	n = n_brow * bm - 3  # the last block row and column overhang n
	V = torch.randn((n, k), device=cuda, dtype=dtype)
	got = bsr.bsr_spmm(blocks, indptr_t, indices, V, n)
	want = bsr.bsr_spmm_ref(blocks, indptr_t, indices, V, n)
	_close_rel(got, want, dtype)
	assert float(got[7 * bm : 8 * bm].abs().max()) == 0.0  # block row 7 is empty


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_bsr_spmm_scalar_path_for_a_misaligned_block(cuda, dtype):
	"""A V whose storage offset breaks 16-byte alignment takes the scalar path of the
	BSR and the node-major DIA kernels, with the same result."""
	blocks, indptr, indices, n = _bsr_arrays(cuda, dtype, 8, 8)
	flat = torch.randn(n * 64 + 1, device=cuda, dtype=dtype)
	V = flat[1:].view(n, 64)
	assert V.is_contiguous() and V.data_ptr() % 16 != 0
	before = _common.SCALAR_LAUNCHES["bsr_spmm"]
	got = bsr.bsr_spmm(blocks, indptr, indices, V, n)
	assert _common.SCALAR_LAUNCHES["bsr_spmm"] == before + 1
	_close_rel(got, bsr.bsr_spmm_ref(blocks, indptr, indices, V, n), dtype)
	before = _common.SCALAR_LAUNCHES["bsr_spmm"]
	bsr.bsr_spmm(blocks, indptr, indices, V.clone(), n)
	assert _common.SCALAR_LAUNCHES["bsr_spmm"] == before
	# The node-major DIA stencil on the same misaligned block.
	bands = torch.rand((3, n), device=cuda, dtype=dtype)
	offs = torch.tensor([-1, 0, 1], device=cuda)
	before = _common.SCALAR_LAUNCHES["dia_stencil"]
	got = dia.dia_stencil(bands, offs, V)
	assert _common.SCALAR_LAUNCHES["dia_stencil"] == before + 1
	_close_rel(got, dia.dia_stencil_ref(bands, offs, V), dtype)


# Offsets read from the shared-memory ring (up to 224) and loaded directly (past it);
# more diagonals than one batch of loads (8).
DIA_OFFSETS = [(-10_000, -7, 0, 3, 10_000), (-225, -224, -100, -9, -1, 0, 1, 9, 100, 224, 225)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("k", [1, 64, 65, 130, 720])
@pytest.mark.parametrize("offsets", DIA_OFFSETS)
def test_dia_stencil_matches_plain_version(cuda, offsets, k, dtype):
	n = 12_000
	g = torch.Generator(device=cuda)
	g.manual_seed(k)
	bands = torch.rand((len(offsets), n), generator=g, device=cuda, dtype=dtype) + 0.5
	offs = torch.tensor(offsets, dtype=torch.int64, device=cuda)
	V = torch.randn((n, k), generator=g, device=cuda, dtype=dtype)
	before = dia.LAUNCHES["dia_stencil"]
	got = dia.dia_stencil(bands, offs, V)
	assert dia.LAUNCHES["dia_stencil"] == before + 1
	_close_rel(got, dia.dia_stencil_ref(bands, offs, V), dtype)
	# The operator takes the probe-major kernel for a probe-major block, the node-major one otherwise.
	op = DIAOperator(bands, offsets, (n, n))
	t_before, n_before = dia.LAUNCHES["dia_stencil_t"], dia.LAUNCHES["dia_stencil"]
	_close_rel(op.matmat(V.T.contiguous().T), got, dtype)
	_close_rel(op.matmat(V), got, dtype)
	assert dia.LAUNCHES["dia_stencil_t"] == t_before + (1 if k > 1 else 0)
	assert dia.LAUNCHES["dia_stencil"] == n_before + (1 if k > 1 else 2)


def test_sparse_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
	blocks, indptr, indices, n = _bsr_arrays(cuda, torch.float32, 8, 8)
	V = torch.randn((n, 4), device=cuda)
	with pytest.raises(TypeError):
		bsr.bsr_spmm(blocks.half(), indptr, indices, V.half(), n)
	with pytest.raises(TypeError):
		bsr.bsr_spmm(blocks, indptr, indices, V.double(), n)
	with pytest.raises(TypeError):  # complex tiles with a real block: the kernel takes one dtype
		bsr.bsr_spmm(blocks.to(torch.complex64), indptr, indices, V, n)
	with pytest.raises(ValueError, match="contiguous"):
		bsr.bsr_spmm(blocks, indptr, indices, torch.randn((4, n), device=cuda).T, n)
	with pytest.raises(ValueError):
		bsr.bsr_spmm(blocks, indptr.cpu(), indices, V, n)
	bands = torch.ones((3, 100), device=cuda)
	offs = torch.tensor([-1, 0, 1], device=cuda)
	with pytest.raises(TypeError):
		dia.dia_stencil(bands.half(), offs, torch.ones((100, 3), device=cuda, dtype=torch.float16))


def test_xtrace_stays_exact_with_tf32_switched_on(cuda):
	"""XTrace at m = n (two rounds of 32) in float32 on a BSR operator, with TF32
	turned on by the caller: the estimators' full-float32 guard gives the same
	estimate as with TF32 off, exact to 1e-4 relative (on an H100 2.2e-6 here,
	and 1.0e-2 with the guard taken out), and the caller's setting is back afterwards."""
	n = 64
	rng = np.random.default_rng(0)
	ew = rng.uniform(0.1, 1.0, n)
	U, _ = np.linalg.qr(rng.normal(size=(n, n)))
	op = BSROperator.from_dense(((U * ew) @ U.T).astype(np.float32), blocksize=(8, 8), device=cuda)
	prev = torch.backends.cuda.matmul.allow_tf32
	try:
		torch.backends.cuda.matmul.allow_tf32 = False
		plain = xtrace(op, batch=32, seed=1)
		torch.backends.cuda.matmul.allow_tf32 = True
		est = xtrace(op, batch=32, seed=1)
		assert torch.backends.cuda.matmul.allow_tf32
	finally:
		torch.backends.cuda.matmul.allow_tf32 = prev
	assert est == plain
	assert abs(est - ew.sum()) / ew.sum() <= 1e-4


def _mesh(side):
	T = sps.diags([-np.ones(side - 1), 2.0 * np.ones(side), -np.ones(side - 1)], [-1, 0, 1])
	eye = sps.identity(side)
	return (sps.identity(side * side) + sps.kron(T, eye) + sps.kron(eye, T)).tocsr()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_basis_and_coeffs_sweeps_through_the_step_kernels(cuda, dtype):
	"""orth = 0 sweeps that return their basis or take coeffs (one- and two-pass f(A)V)
	run both step kernels once per step, and meet the same sweeps with the step's
	tail in PyTorch."""
	tol = TOL[dtype][1]
	A = _mesh(120)
	op = DIAOperator.from_scipy(A, dtype=dtype, device=cuda)
	tail = _TailDIA(op.bands, op.offsets, op.shape)
	g = torch.Generator(device=cuda)
	g.manual_seed(5)
	V0 = torch.randn((A.shape[0], 6), generator=g, device=cuda, dtype=dtype)
	C = torch.randn((12, 3, 6), generator=g, device=cuda, dtype=dtype)
	outs = []
	for sweep_op in (op, tail):
		dia.reset_launches()
		basis = lanczos_block_op(sweep_op, V0, deg=12, ncv=12, orth=0, return_basis=True)
		two = lanczos_block_op(sweep_op, V0, deg=12, ncv=2, orth=0, return_basis=False, coeffs=C)
		outs.append((basis, two, dict(dia.LAUNCHES)))
	(basis, two, launches), (basis_t, two_t, launches_t) = outs
	assert launches["lanczos_dia_step"] == launches["lanczos_dia_residual"] == 24
	assert launches_t["lanczos_dia_residual"] == 0 and launches_t["dia_stencil_t"] == 24
	torch.testing.assert_close(basis.alphas, basis_t.alphas, rtol=tol, atol=tol)
	torch.testing.assert_close(basis.Q, basis_t.Q, rtol=tol, atol=tol)
	torch.testing.assert_close(two.y, two_t.y, rtol=tol, atol=tol)
	Q = basis.Q.permute(2, 0, 1)  # (nv, deg, n): orthonormal rows per probe
	eye = torch.eye(12, dtype=dtype, device=cuda).expand(6, 12, 12)
	torch.testing.assert_close(Q @ Q.transpose(1, 2), eye, rtol=0, atol=100 * tol)
	for two_pass, per in ((False, 12), (True, 24)):
		dia.reset_launches()
		Y = MatrixFunction(op, "exp", t=-1.0, deg=12, orth=0, two_pass=two_pass).matmat(V0)
		assert dia.LAUNCHES["lanczos_dia_step"] == dia.LAUNCHES["lanczos_dia_residual"] == per
		Y_t = MatrixFunction(tail, "exp", t=-1.0, deg=12, orth=0, two_pass=two_pass).matmat(V0)
		torch.testing.assert_close(Y, Y_t, rtol=tol, atol=tol)


def test_stacked_quadrature_on_dia_matches_the_pytorch_tail(cuda):
	"""A stacked heat-kernel family from one sweep through the step kernels, against the
	same family through the PyTorch tail, float32 at 1e-5."""
	from primate_tpu_torch import diag, stacked

	A = _mesh(200)
	op = DIAOperator.from_scipy(A, dtype=torch.float32, device=cuda)
	tail = _TailDIA(op.bands, op.offsets, op.shape)
	fam = stacked("exp", -np.geomspace(0.05, 4.0, 8))
	g = torch.Generator(device=cuda)
	g.manual_seed(6)
	X = (torch.randint(0, 2, (32, A.shape[0]), generator=g, device=cuda, dtype=torch.float32) * 2 - 1).T
	dia.reset_launches()
	got = MatrixFunction(op, fam, deg=20, orth=0).quad(X)
	assert got.shape == (8, 32) and dia.LAUNCHES["lanczos_dia_residual"] == 20
	want = MatrixFunction(tail, fam, deg=20, orth=0).quad(X)
	torch.testing.assert_close(got, want, rtol=1e-5, atol=0)
	est = hutch(MatrixFunction(op, fam, deg=20, orth=0), batch=16, converge="count", count=32, seed=1)
	est_t = hutch(MatrixFunction(tail, fam, deg=20, orth=0), batch=16, converge="count", count=32, seed=1)
	np.testing.assert_allclose(est, est_t, rtol=1e-5)
	d = diag(MatrixFunction(op, fam, deg=20, orth=0), batch=16, converge="count", count=2, seed=2)
	d_t = diag(MatrixFunction(tail, fam, deg=20, orth=0), batch=16, converge="count", count=2, seed=2)
	assert d.shape == (8, A.shape[0])
	np.testing.assert_allclose(d, d_t, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_csr_applies_on_the_card_match_the_cpu(cuda, dtype):
	"""CSR matmat, matmat_t, matvec and rmatvec through cuSPARSE against the CPU operator,
	on a power-law graph with hub rows, float32 and float64."""
	from benchmarks.matrices import powerlaw_laplacian

	from primate_tpu_torch import CSROperator

	A = powerlaw_laplacian(n=20_000, m=4, seed=1)
	gpu, cpu = CSROperator.from_scipy(A, dtype=dtype, device=cuda), CSROperator.from_scipy(A, dtype=dtype, device="cpu")
	tol = SPARSE_TOL[dtype]
	X = torch.randn((A.shape[0], 64), dtype=dtype)
	for got, want in (
		(gpu.matmat(X.to(cuda)), cpu.matmat(X)),
		(gpu.matmat(X.T.contiguous().to(cuda).T), cpu.matmat(X)),
		(gpu.matmat_t(X.T.contiguous().to(cuda)), cpu.matmat_t(X.T.contiguous())),
		(gpu.matvec(X[:, 0].to(cuda)), cpu.matvec(X[:, 0])),
		(gpu.rmatvec(X[:, 1].to(cuda)), cpu.rmatvec(X[:, 1])),
	):
		got = got.cpu()
		assert float((got - want).abs().max()) <= tol * float(want.abs().max())
	assert gpu.matmat_t(X.T.contiguous().to(cuda)).is_contiguous()



# --- the backward of the kernel Functions (``ops.autograd``) -------------------------------


def _bsr_sparse(dev, dtype, n, density, bs=8, seed=0):
	"""A random sparse matrix (no dense copy) as 8×8 BSR tiles; n need not be a multiple of 8."""
	S = sps.random(n, n, density=density, random_state=np.random.default_rng(seed), format="csr")
	S.resize((-(-n // bs) * bs,) * 2)
	S = S.tobsr(blocksize=(bs, bs))
	as_dev = lambda x, dt: torch.tensor(x, dtype=dt, device=dev)  # noqa: E731
	return as_dev(S.data, dtype), as_dev(S.indptr, torch.int64), as_dev(S.indices, torch.int64)


def _functions(dev, dtype, n_dia, n_bsr, k, offsets, density=0.02, seed=0):
	"""Each Function beside its plain version on the same inputs: (name, Function, plain, inputs, cotangent)."""
	from primate_tpu_torch.ops import autograd as kad

	g = torch.Generator(device=dev)
	g.manual_seed(seed)
	rnd = lambda *shape: torch.randn(shape, generator=g, device=dev, dtype=dtype)  # noqa: E731
	offs = torch.tensor(offsets, dtype=torch.int64, device=dev)
	bands = rnd(len(offsets), n_dia).requires_grad_(True)  # not symmetric: the adjoint bands differ from the bands
	x, V = rnd(k, n_dia).requires_grad_(True), rnd(n_dia, k).requires_grad_(True)
	blocks, indptr, indices = _bsr_sparse(dev, dtype, n_bsr, density, seed=seed)
	if dtype.is_complex:  # complex tiles: the adjoint's conjugate shows
		blocks = torch.complex(blocks.real, torch.randn(blocks.shape, generator=g, device=dev, dtype=dtype.to_real()))
	blocks.requires_grad_(True)
	Vb = rnd(n_bsr, k).requires_grad_(True)
	return [
		("dia_stencil_t", lambda b, v: kad.dia_stencil_t_ad(b, v, offs, offsets), lambda b, v: dia.dia_stencil_t_ref(b, offs, v), (bands, x), rnd(k, n_dia)),
		("dia_stencil", lambda b, v: kad.dia_stencil_ad(b, v, offs, offsets), lambda b, v: dia.dia_stencil_ref(b, offs, v), (bands, V), rnd(n_dia, k)),
		("bsr_spmm", lambda b, v: kad.bsr_spmm_ad(b, v, indptr, indices, n_bsr), lambda b, v: bsr.bsr_spmm_ref(b, indptr, indices, v, n_bsr),
			(blocks, Vb), rnd(n_bsr, k)),
	]


@pytest.mark.parametrize("dtype", [torch.float64, torch.complex128])
def test_kernel_functions_pass_gradcheck(cuda, dtype):
	"""float64 and complex128 (Wirtinger) at small shapes: each Function's backward (kernels on the
	conjugated adjoint structure, PyTorch parameter reductions) against finite differences."""
	for name, fn, _, inputs, _ in _functions(cuda, dtype, 61, 45, 3, (-9, -1, 0, 2, 30), density=0.05):
		before = dia.LAUNCHES[name]
		assert torch.autograd.gradcheck(fn, inputs, eps=1e-6, atol=1e-8, rtol=1e-6), name
		assert dia.LAUNCHES[name] > before


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.complex64, torch.complex128])
def test_kernel_backward_matches_autograd_of_the_plain_versions(cuda, dtype):
	"""The FEM cell's DIA pattern at n = 1M (7 diagonals to ±10,000, 64 probes) and 8×8 BSR
	tiles on n = 200,003 (a ragged last block): input and parameter gradients within 1e-5
	(float32, complex64) or 1e-12 (float64, complex128) of the largest entry of the plain version's
	autograd; each backward launches its kernel once, for the adjoint apply (complex: on the
	conjugated adjoint bands or tiles). Complex128 at a quarter of the BSR density: the plain version's
	graph holds every gathered tile's rows (34 GB at 1e-4), and with both gradients that outgrew the card."""
	density = 2.5e-5 if dtype == torch.complex128 else 1e-4
	cases = _functions(cuda, dtype, 1_000_000, 200_003, 64, (-10_000, -100, -1, 0, 1, 100, 10_000), density=density)
	for name, fn, plain, inputs, G in cases:
		out = fn(*inputs)
		assert type(out.grad_fn).__name__.endswith("Backward")
		before = dia.LAUNCHES[name]
		got = torch.autograd.grad(out, inputs, G)
		assert dia.LAUNCHES[name] == before + 1
		want = torch.autograd.grad(plain(*inputs), inputs, G)
		for gv, wv in zip(got, want):
			_close_rel(gv, wv, dtype)


# --- complex (Hermitian) stencils ----------------------------------------------------
#
# (nv, n, offsets[, lead]): the tight-binding cell's probe block and offsets at a cut n
# (the full 4,096,000 sites run in chip_smoke.py phase 15), probe counts 1, 7 and 65, n
# odd, offsets at and past n, and a block one element past a 16-byte boundary, which
# takes the complex64 scalar path. Tolerance: max-abs error over max|out|.
CPLX_SHAPES = [
	(16, 409_600, (-409_600 + 2048, -2048, -2047, -1, 1, 2047, 2048, 409_600 - 2048)),
	(1, 12_001, (-10_001, -1, 0, 1, 10_001)), (7, 3001, (-200, -7, 0, 7, 200)),
	(65, 5000, (-5000, -4999, -1, 0, 1, 4999, 5000, 6000)),
	(13, 12_000, (-10_000, -7, 0, 3, 10_000), 1),
]
CPLX_TOL = {torch.complex64: 1e-6, torch.complex128: 1e-14}


def _cplx(dev, shape, dtype, seed=0):
	g = torch.Generator(device=dev)
	g.manual_seed(seed)
	r = dtype.to_real()
	return torch.complex(torch.randn(shape, generator=g, device=dev, dtype=r), torch.randn(shape, generator=g, device=dev, dtype=r))


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("shape", CPLX_SHAPES)
def test_complex_stencils_match_plain_versions(cuda, shape, dtype):
	nv, n, offsets = shape[:3]
	lead = shape[3] if len(shape) > 3 else 0
	bands = _cplx(cuda, (len(offsets), n), dtype, seed=1)
	offs = torch.tensor(offsets, dtype=torch.int64, device=cuda)
	x = _cplx(cuda, (lead + nv * n,), dtype, seed=2)[lead:].view(nv, n)
	scalar = not _common.vector_ok(n, x.element_size(), x)
	assert scalar == (dtype == torch.complex64 and (n % 2 == 1 or lead == 1))  # complex128: always 16-byte vectors
	before, scalar_before = dict(dia.LAUNCHES), dict(_common.SCALAR_LAUNCHES)
	got, want = dia.dia_stencil_t(bands, offs, x), dia.dia_stencil_t_ref(bands, offs, x)
	V = x.T.contiguous()  # node-major (n, nv)
	got_nm, want_nm = dia.dia_stencil(bands, offs, V), dia.dia_stencil_ref(bands, offs, V)
	torch.cuda.synchronize()
	assert dia.LAUNCHES["dia_stencil_t"] == before["dia_stencil_t"] + 1 and dia.LAUNCHES["dia_stencil"] == before["dia_stencil"] + 1
	assert _common.SCALAR_LAUNCHES["dia_stencil_t"] == scalar_before["dia_stencil_t"] + scalar
	assert got.dtype == dtype and got_nm.dtype == dtype
	assert float((got - want).abs().max()) <= CPLX_TOL[dtype] * float(want.abs().max())
	assert float((got_nm - want_nm).abs().max()) <= CPLX_TOL[dtype] * float(want_nm.abs().max())


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_complex_node_major_stencil_at_the_cell_width(cuda, dtype):
	"""``dia_stencil`` on an (n, 64) block (the node-major QR blocks of the sketches) and on a
	misaligned one, which takes the complex64 scalar path."""
	n, offsets = 200_000, (-200_000 + 2048, -2048, -2047, -1, 1, 2047, 2048, 200_000 - 2048)
	bands = _cplx(cuda, (len(offsets), n), dtype, seed=3)
	offs = torch.tensor(offsets, dtype=torch.int64, device=cuda)
	for lead in (0, 1):
		V = _cplx(cuda, (lead + n * 64,), dtype, seed=4)[lead:].view(n, 64)
		before = _common.SCALAR_LAUNCHES["dia_stencil"]
		got, want = dia.dia_stencil(bands, offs, V), dia.dia_stencil_ref(bands, offs, V)
		torch.cuda.synchronize()
		assert _common.SCALAR_LAUNCHES["dia_stencil"] == before + (lead == 1 and dtype == torch.complex64)
		assert float((got - want).abs().max()) <= CPLX_TOL[dtype] * float(want.abs().max())


# (nv, n, offsets, lead) for the complex step passes: the tight-binding cell's probe block and offsets
# at a cut n, then ``chip_smoke.py``'s awkward shapes (``CPLX_STEP_SHAPES``, described there).
CPLX_STEP_SHAPES = [
	(16, 409_600, (-409_600 + 2048, -2048, -2047, -1, 1, 2047, 2048, 409_600 - 2048), 0),
	*chip_smoke.CPLX_STEP_SHAPES,
]
# α: |Δα| over ‖q‖·‖w‖ of its probe, the Cauchy-Schwarz bound of |α| (α sums n terms of both signs,
# so a relative error of α itself says little where it nearly cancels); β' = ‖v‖: relative.
CPLX_AB_TOL = {torch.complex64: 1e-5, torch.complex128: 1e-12}


def _cplx_step_inputs(dev, nv, n, offsets, dtype, lead):
	g = torch.Generator(device=dev)
	g.manual_seed(15)
	r = dtype.to_real()
	bands = _cplx(dev, (len(offsets), n), dtype, seed=5)
	offs = torch.tensor(offsets, dtype=torch.int64, device=dev)

	def carry(seed):
		X = _cplx(dev, (lead + nv * n,), dtype, seed=seed)[lead:].view(nv, n)
		return X.div_(torch.linalg.vector_norm(X, dim=1, keepdim=True))

	state = dia.lanczos_state(nv, r, dev)
	state.scal[dia.DIV_CUR] = torch.rand(nv, generator=g, device=dev, dtype=r) + 0.5
	state.scal[dia.DIV_PREV] = torch.rand(nv, generator=g, device=dev, dtype=r) + 0.5
	state.scal[dia.BETA] = torch.rand(nv, generator=g, device=dev, dtype=r) + 0.5
	# Probe 0 broke down a step ago: its divisor is inf, so its q is 0 (not NaN), and it is done.
	state.scal[dia.DIV_CUR, 0] = torch.inf
	state.scal[dia.BETA, 0] = 1e-9
	state.scal[dia.DONE, 0] = 1.0
	return bands, offs, carry(6), carry(7), state


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("shape", CPLX_STEP_SHAPES)
def test_complex_step_kernels_match_plain_versions(cuda, shape, dtype):
	"""The complex step passes against the plain step, three steps of a flat sweep, each from the same
	blocks and state (the kernels' own, cloned for the plain step), then pass A alone
	(``lanczos_dia_step``): v within ``CPLX_TOL`` of its largest entry, α and β within ``CPLX_AB_TOL``,
	the done flags equal, the broken-down probe's α and β zero and its block finite. Each step launches
	both passes once, ``dia_stencil_t`` no time, on the scalar path exactly where complex64's 16-byte
	vectors are ruled out (n odd, a misaligned block)."""
	nv, n, offsets, lead = shape
	bands, offs, v_cur, v_prev, state = _cplx_step_inputs(cuda, nv, n, offsets, dtype, lead)
	r = dtype.to_real()
	scalar = not _common.vector_ok(n, v_cur.element_size(), v_cur, v_prev, bands)
	assert scalar == (dtype == torch.complex64 and (n % 2 == 1 or lead == 1))
	apply_ref = lambda q: dia.dia_stencil_t_ref(bands, offs, q)  # noqa: E731
	for _ in range(3):
		# The third step's blocks are the kernel's own outputs, aligned: a misaligned start leaves the path then.
		scalar = not _common.vector_ok(n, v_cur.element_size(), v_cur, v_prev, bands)
		st_ref = dia.LanczosState(state.scal.clone(), torch.zeros(1, dtype=torch.int32, device=cuda))
		a, b = torch.empty(nv, dtype=r, device=cuda), torch.empty(nv, dtype=r, device=cuda)
		a_ref, b_ref = torch.empty_like(a), torch.empty_like(b)
		before, scalar_before = dict(dia.LAUNCHES), dict(_common.SCALAR_LAUNCHES)
		v = dia.lanczos_dia_sweep_step(bands, offs, v_cur, v_prev, state, a, b, 1e-8)
		launched = {k: dia.LAUNCHES[k] - before[k] for k in ("lanczos_dia_step", "lanczos_dia_residual", "dia_stencil_t")}
		assert launched == {"lanczos_dia_step": 1, "lanczos_dia_residual": 1, "dia_stencil_t": 0}
		assert _common.SCALAR_LAUNCHES["lanczos_dia_step"] - scalar_before["lanczos_dia_step"] == scalar
		assert _common.SCALAR_LAUNCHES["lanczos_dia_residual"] - scalar_before["lanczos_dia_residual"] == scalar
		v_ref = dia.lanczos_sweep_step_ref(apply_ref, v_cur, v_prev, st_ref, a_ref, b_ref, 1e-8)
		torch.cuda.synchronize()
		assert v.dtype == dtype and a.dtype == r and bool(torch.isfinite(torch.view_as_real(v)).all())
		assert float((v - v_ref).abs().max()) <= CPLX_TOL[dtype] * float(v_ref.abs().max())
		q = v_cur / st_ref.scal[dia.DIV_PREV, :, None]  # the step's q (the state has advanced)
		w = v_ref + st_ref.scal[dia.ALPHA, :, None] * q
		scale = torch.linalg.vector_norm(q, dim=1) * torch.linalg.vector_norm(w, dim=1)
		assert float(((a - a_ref).abs() / scale.clamp_min(1e-30))[1:].max()) <= CPLX_AB_TOL[dtype]
		assert float(((b - b_ref).abs() / b_ref.abs().clamp_min(1e-30))[1:].max()) <= CPLX_AB_TOL[dtype]
		assert a[0] == 0 and b[0] == 0 and torch.equal(state.scal[dia.DONE], st_ref.scal[dia.DONE])
		assert int(state.ticket) == 0
		v_prev, v_cur = v_cur, v
	beta = torch.rand(nv, device=cuda, dtype=r) + 0.5
	_, _, q_cur, q_prev, _ = _cplx_step_inputs(cuda, nv, n, offsets, dtype, lead)  # unit rows (probe 0's v is 0 by now)
	before = dict(dia.LAUNCHES)
	w, alpha = dia.lanczos_dia_step(bands, offs, q_cur, q_prev, beta)
	assert dia.LAUNCHES["lanczos_dia_step"] == before["lanczos_dia_step"] + 1 and dia.LAUNCHES["dia_stencil_t"] == before["dia_stencil_t"]
	w_ref, alpha_ref = dia.lanczos_dia_step_ref(bands, offs, q_cur, q_prev, beta)
	torch.cuda.synchronize()
	assert w.dtype == dtype and alpha.dtype == r
	assert float((w - w_ref).abs().max()) <= CPLX_TOL[dtype] * float(w_ref.abs().max())
	scale = torch.linalg.vector_norm(w_ref, dim=1)
	assert float(((alpha - alpha_ref).abs() / scale).max()) <= CPLX_AB_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("shape", CPLX_STEP_SHAPES)
def test_complex_pass_a_is_the_plain_pass_a_bit_for_bit(cuda, shape, dtype):
	"""Complex pass A in the sweep's mode (the state's divisors and β, a broken-down probe 0) against the
	plain pass A on the same blocks and state: ``w`` equal bit for bit (the kernel divides, multiplies
	and adds as PyTorch's ops round on the card, and sums the diagonals in their order), α within
	``CPLX_AB_TOL`` of ‖q‖·‖w‖ (the partial sums' order differs)."""
	nv, n, offsets, lead = shape
	bands, offs, v_cur, v_prev, state = _cplx_step_inputs(cuda, nv, n, offsets, dtype, lead)
	r = dtype.to_real()
	st_ref = dia.LanczosState(state.scal.clone(), torch.zeros(1, dtype=torch.int32, device=cuda))
	a, a_ref = torch.empty(nv, dtype=r, device=cuda), torch.empty(nv, dtype=r, device=cuda)
	from primate_tpu_torch.ops._build import load_library

	w, _, _, vec = dia._launch_pass_a(load_library(), bands, offs, v_cur, v_prev, state.scal, state.ticket, a)
	w_ref = dia.lanczos_sweep_pass_a_ref(lambda q: dia.dia_stencil_t_ref(bands, offs, q), v_cur, v_prev, st_ref, a_ref)
	torch.cuda.synchronize()
	assert vec == (dtype == torch.complex128 or (n % 2 == 0 and lead == 0))
	as_int = torch.int32 if dtype == torch.complex64 else torch.int64
	assert torch.equal(torch.view_as_real(w).view(as_int), torch.view_as_real(w_ref).view(as_int))
	q = v_cur / st_ref.scal[dia.DIV_CUR, :, None]
	scale = torch.linalg.vector_norm(q, dim=1) * torch.linalg.vector_norm(w_ref, dim=1)
	assert a[0] == 0 and float(((a - a_ref).abs() / scale.clamp_min(1e-30))[1:].max()) <= CPLX_AB_TOL[dtype]
	assert torch.equal(state.scal[dia.ALPHA][1:], a[1:]) and int(state.ticket) == 0


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_complex_sweeps_on_the_card_match_the_cpu_port(cuda, dtype):
	"""``lanczos_block_op`` on a Hermitian DIA operator (a 15 × 41 Hofstadter lattice plus a diagonal,
	n odd) at ``orth`` 0 and 5 on the card against the CPU port on the same probes: at 0 both passes a
	step, at 5 pass A alone, ``dia_stencil_t`` no time. Then a probe in a 3-dimensional invariant
	subspace of a complex tridiagonal operator breaks down at step 3: α and β exactly zero after it."""
	nx, ny = 15, 41
	x, y = np.repeat(np.arange(nx), ny), np.tile(np.arange(ny), nx)
	i, jx, jy = x * ny + y, (x + 1) % nx * ny + y, x * ny + (y + 1) % ny
	t = -np.exp(2j * np.pi * 0.2 * x)
	H = sps.csr_matrix((np.r_[-np.ones(2 * i.size), t, t.conj()], (np.r_[i, jx, i, jy], np.r_[jx, i, jy, i])), shape=(nx * ny,) * 2)
	H = H + sps.diags(np.linspace(-1.0, 1.0, nx * ny))
	op, op_cpu = DIAOperator.from_scipy(H, dtype=dtype, device=cuda), DIAOperator.from_scipy(H, dtype=dtype, device="cpu")
	rng = np.random.default_rng(15)
	Vt = torch.tensor(rng.normal(size=(nx * ny, 11)) + 1j * rng.normal(size=(nx * ny, 11))).to(dtype)
	# complex64: a shorter sweep, before its Ritz values converge and round-off differences grow.
	deg, tol = (12, 1e-4) if dtype == torch.complex64 else (24, 1e-10)
	for orth, want_steps in ((0, (deg, deg)), (5, (deg, 0))):
		dia.reset_launches()
		got = lanczos_block_op(op, Vt.to(cuda), deg=deg, ncv=6, orth=orth)
		torch.cuda.synchronize()
		assert (dia.LAUNCHES["lanczos_dia_step"], dia.LAUNCHES["lanczos_dia_residual"]) == want_steps
		assert dia.LAUNCHES["dia_stencil_t"] == 0
		want = lanczos_block_op(op_cpu, Vt, deg=deg, ncv=6, orth=orth)
		for g, w in ((got.alphas, want.alphas), (got.betas, want.betas)):
			assert g.dtype == dtype.to_real()
			assert float((g.cpu() - w).abs().max()) <= tol * float(w.abs().max())
	n = 50
	off = -0.5 * np.exp(1j * np.linspace(0.0, 3.0, n - 1))
	off[2] = 0.0
	A = sps.diags([off.conj(), np.linspace(1.0, 4.0, n), off], [-1, 0, 1]).tocsr()
	V0 = rng.normal(size=(n, 4)) + 1j * rng.normal(size=(n, 4))
	V0[3:, 0] = 0.0
	rtol = 1e-5 if dtype == torch.complex64 else 1e-8  # complex64 leaves β₃ at its round-off
	for orth in (0, 5):
		kw = dict(deg=8, ncv=8, orth=orth, rtol=rtol)
		got = lanczos_block_op(DIAOperator.from_scipy(A, dtype=dtype, device=cuda), torch.tensor(V0).to(dtype).to(cuda), **kw)
		want = lanczos_block_op(DIAOperator.from_scipy(A, dtype=dtype, device="cpu"), torch.tensor(V0).to(dtype), **kw)
		a, b = got.alphas.cpu(), got.betas.cpu()
		assert float(b[2, 0]) < 1e-5 and bool(torch.all(a[3:, 0] == 0)) and bool(torch.all(b[3:, 0] == 0))
		assert bool(torch.all(want.alphas[3:, 0] == 0)) and bool(torch.all(want.betas[3:, 0] == 0))
		torch.testing.assert_close(a, want.alphas, rtol=1e-4, atol=1e-4)
		torch.testing.assert_close(b, want.betas, rtol=1e-4, atol=1e-4)


def test_complex_operators_on_the_card(cuda):
	"""A Hermitian DIA operator's Lanczos sweep takes the complex step kernels (passes A and B a
	step, no ``dia_stencil_t``) and matches the CPU port; a complex BSR apply takes the complex
	``bsr_spmm``, and a complex stencil's backward, on a conjugate-view cotangent, launches the
	kernel on the conjugated adjoint bands and matches the plain version's autograd."""
	nx = ny = 40
	rng = np.random.default_rng(0)
	x, y = np.repeat(np.arange(nx), ny), np.tile(np.arange(ny), nx)
	i, jx, jy = x * ny + y, (x + 1) % nx * ny + y, x * ny + (y + 1) % ny
	t = -np.exp(2j * np.pi * 0.2 * x)
	H = sps.csr_matrix((np.r_[-np.ones(2 * i.size), t, t.conj()], (np.r_[i, jx, i, jy], np.r_[jx, i, jy, i])), shape=(nx * ny,) * 2)
	op, op_cpu = DIAOperator.from_scipy(H, device=cuda), DIAOperator.from_scipy(H, device="cpu")
	V0 = rng.normal(size=(nx * ny, 8)) + 1j * rng.normal(size=(nx * ny, 8))
	dia.reset_launches()
	out = lanczos_block_op(op, torch.tensor(V0, device=cuda), deg=20, ncv=2, orth=0, return_basis=False)
	assert dia.LAUNCHES["dia_stencil_t"] == 0 and dia.LAUNCHES["lanczos_dia_step"] == dia.LAUNCHES["lanczos_dia_residual"] == 20
	want = lanczos_block_op(op_cpu, torch.tensor(V0), deg=20, ncv=2, orth=0, return_basis=False)
	np.testing.assert_allclose(out.alphas.cpu().numpy(), want.alphas.numpy(), rtol=0, atol=1e-12)
	np.testing.assert_allclose(out.betas.cpu().numpy(), want.betas.numpy(), rtol=0, atol=1e-12)
	blocks, indptr, indices, n = _bsr_arrays(cuda, torch.float64, 8, 8)
	C = BSROperator((blocks * (1 + 0.5j)).to(torch.complex128), indices, indptr, (n, n))
	X = torch.ones((n, 2), device=cuda, dtype=torch.complex128)
	before = bsr.LAUNCHES["bsr_spmm"]
	got = C.matmat(X)
	assert bsr.LAUNCHES["bsr_spmm"] == before + 1
	want = bsr.bsr_spmm_ref(C.blocks, indptr, indices, X, n)
	assert float((got - want).abs().max()) <= _tol(torch.complex128) * float(want.abs().max())
	bands = op.bands.clone().requires_grad_(True)
	x = torch.tensor(V0.T.copy(), device=cuda).requires_grad_(True)
	G = torch.tensor(V0.T[::-1].copy(), device=cuda)
	y = ptt_autograd.dia_stencil_t_ad(bands, x, op.offsets_t, op.offsets)
	before = dia.LAUNCHES["dia_stencil_t"]
	got = torch.autograd.grad(y, (bands, x), G.conj())  # the cotangent a lazy conjugate view
	assert dia.LAUNCHES["dia_stencil_t"] == before + 1
	want = torch.autograd.grad(dia.dia_stencil_t_ref(bands, op.offsets_t, x), (bands, x), G.conj())
	for gv, wv in zip(got, want):
		assert float((gv - wv).abs().max()) <= 1e-12 * float(wv.abs().max())


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("wrapper", ["dia_stencil_t", "dia_stencil", "bsr_spmm"])
def test_complex_wrappers_take_conjugate_views(cuda, wrapper, dtype):
	"""A lazy conjugate view (``x.conj()`` shares ``x``'s memory and carries a flag) handed to a
	complex kernel wrapper, as input and as bands or tiles: the kernel runs on the written-out
	values and gives the plain version's result (it read the unconjugated memory before)."""
	n, k = 3001, 5
	if wrapper == "bsr_spmm":
		blocks, indptr, indices = _bsr_sparse(cuda, dtype, n, 0.01)
		blocks = torch.complex(blocks.real, torch.ones_like(blocks.real))
		A, X = blocks.conj(), _cplx(cuda, (n, k), dtype).conj()
		call = lambda a, x: bsr.bsr_spmm(a, indptr, indices, x, n)  # noqa: E731
		plain = lambda a, x: bsr.bsr_spmm_ref(a, indptr, indices, x, n)  # noqa: E731
	else:
		offs = torch.tensor([-7, -1, 0, 2, 300], device=cuda)
		A = _cplx(cuda, (5, n), dtype, seed=3).conj()
		X = _cplx(cuda, (k, n) if wrapper == "dia_stencil_t" else (n, k), dtype, seed=4).conj()
		call = lambda a, x: getattr(dia, wrapper)(a, offs, x)  # noqa: E731
		plain = lambda a, x: getattr(dia, f"{wrapper}_ref")(a, offs, x)  # noqa: E731
	assert A.is_conj() and X.is_conj() and X.is_contiguous()
	before = dia.LAUNCHES[wrapper]
	got, want = call(A, X), plain(A, X)
	assert dia.LAUNCHES[wrapper] == before + 1
	assert float((got - want).abs().max()) <= 10 * _tol(dtype) * float(want.abs().max())
	assert float((got - call(A.resolve_conj(), X.resolve_conj())).abs().max()) == 0.0


def test_complex64_sketch_stays_exact_with_tf32_switched_on(cuda):
	"""Hutch++ at m = n on a complex64 Hermitian operator with TF32 turned on by the caller:
	cuBLAS complex64 GEMMs obey the same switch, and the full-float32 guard keeps the sketch exact."""
	from primate_tpu_torch import hermitian, hutchpp

	n = 60
	ew = np.random.default_rng(1).uniform(0.2, 2.0, n)
	A = hermitian(n, ew=ew, seed=2, dtype=torch.complex64, device=cuda)
	prev = torch.backends.cuda.matmul.allow_tf32
	try:
		torch.backends.cuda.matmul.allow_tf32 = True
		est = hutchpp(A, m=n, seed=3)
		assert torch.backends.cuda.matmul.allow_tf32
	finally:
		torch.backends.cuda.matmul.allow_tf32 = prev
	assert abs(est - ew.sum()) / ew.sum() <= 1e-4


# The adjoint applies: offsets inside, at and past n; rectangular tiles with empty block rows.
ADJ_OFFSETS = [(-1, 0, 1), (-200, -7, 0, 7, 200), (-3001, -5, 0, 3000, 4000)]


def _tol(dtype):
	return {torch.float32: 1e-5, torch.float64: 1e-12, torch.complex64: 1e-6, torch.complex128: 1e-14}[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.complex64])
@pytest.mark.parametrize("layout", ["node_major", "probe_major", "vector"])
@pytest.mark.parametrize("offsets", ADJ_OFFSETS)
def test_dia_adjoint_applies_match_plain_versions(cuda, offsets, layout, dtype):
	n, k = 3001, 13
	g = torch.Generator(device=cuda)
	g.manual_seed(3)
	bands = torch.randn((len(offsets), n), generator=g, device=cuda, dtype=dtype)
	op = DIAOperator(bands, offsets, (n, n))
	V = torch.randn((n, k), generator=g, device=cuda, dtype=dtype)
	V = {"node_major": V, "probe_major": V.T.contiguous().T, "vector": V[:, 0]}[layout]
	kernel = "dia_stencil" if layout == "node_major" else "dia_stencil_t"
	before = dict(dia.LAUNCHES)
	got = op.rmatmat(V)
	torch.cuda.synchronize()
	assert dia.LAUNCHES[kernel] == before[kernel] + 1
	want = op.rmatmat_plain(V)
	assert float((got - want).abs().max()) <= _tol(dtype) * float(want.abs().max())
	if layout == "probe_major":
		Ut = V.T.contiguous()
		got_t = op.rmatmat_t(Ut)
		assert float((got_t - want.T).abs().max()) <= _tol(dtype) * float(want.abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("tile", [(8, 8), (8, 16), (4, 4)])
@pytest.mark.parametrize("k", [1, 16, 65])
def test_bsr_adjoint_on_transposed_tiles_matches_plain_version(cuda, tile, k, dtype):
	m, n = 1003, 517
	A = sps.random(m, n, density=0.01, random_state=np.random.default_rng(4), format="lil")
	A[200:400] = 0  # empty block rows
	A = A.tocsr()
	A.eliminate_zeros()
	op = BSROperator.from_scipy(A, blocksize=tile, dtype=dtype, device=cuda)
	g = torch.Generator(device=cuda)
	g.manual_seed(5)
	U = torch.randn((m, k), generator=g, device=cuda, dtype=dtype)
	before = bsr.LAUNCHES["bsr_spmm"]
	got = op.rmatmat(U)
	torch.cuda.synchronize()
	assert bsr.LAUNCHES["bsr_spmm"] == before + 1
	want = op.rmatmat_plain(U)
	assert got.shape == (n, k)
	assert float((got - want).abs().max()) <= _tol(dtype) * float(want.abs().max())
	dense = torch.tensor(A.toarray(), dtype=torch.float64, device=cuda)
	assert float((got.double() - dense.T @ U.double()).abs().max()) <= 10 * _tol(dtype) * float(want.abs().max())


def _cplx_bsr(dev, dtype, bm, bn, n=1001, seed=0):
	"""``_bsr_arrays``' pattern with complex tiles: real parts as there, seeded imaginary parts."""
	blocks, indptr, indices, n = _bsr_arrays(dev, real_dtype(dtype), bm, bn, n=n, seed=seed)
	g = torch.Generator(device=dev)
	g.manual_seed(seed + 1)
	imag = torch.randn(blocks.shape, generator=g, device=dev, dtype=blocks.dtype) * (blocks != 0)
	return torch.complex(blocks, imag).contiguous(), indptr, indices, n


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("k", [1, 3, 64, 65, 240])
@pytest.mark.parametrize("tile", [(8, 16), (4, 4), (8, 8)])
def test_complex_bsr_spmm_matches_plain_version(cuda, tile, k, dtype):
	"""The complex instantiations of ``bsr_spmm``, with an empty block row, against ``bsr_spmm_ref``."""
	blocks, indptr, indices, n = _cplx_bsr(cuda, dtype, *tile)
	V = _cplx(cuda, (n, k), dtype, seed=k)
	before = bsr.LAUNCHES["bsr_spmm"]
	got = bsr.bsr_spmm(blocks, indptr, indices, V, n)
	assert bsr.LAUNCHES["bsr_spmm"] == before + 1
	want = bsr.bsr_spmm_ref(blocks, indptr, indices, V, n)
	torch.cuda.synchronize()
	assert got.dtype == dtype and float((got - want).abs().max()) <= _tol(dtype) * float(want.abs().max())
	assert float(got[3 * tile[0] : 4 * tile[0]].abs().max()) == 0.0  # the empty block row


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_complex_bsr_spmm_scalar_path_and_adjoint(cuda, dtype):
	"""A misaligned complex block takes the scalar path (complex64: a 16-byte vector holds two);
	a complex BSR operator's adjoint is ``bsr_spmm`` on the conjugated transposed tiles, held to
	``rmatmat_plain`` and to the dense conjugate transpose."""
	blocks, indptr, indices, n = _cplx_bsr(cuda, dtype, 8, 8)
	flat = _cplx(cuda, (n * 64 + 1,), dtype, seed=2)
	V = flat[1:].view(n, 64)
	before = _common.SCALAR_LAUNCHES["bsr_spmm"]
	got = bsr.bsr_spmm(blocks, indptr, indices, V, n)
	assert _common.SCALAR_LAUNCHES["bsr_spmm"] == before + (dtype == torch.complex64)  # one complex128 is 16 bytes
	want = bsr.bsr_spmm_ref(blocks, indptr, indices, V, n)
	torch.cuda.synchronize()
	assert float((got - want).abs().max()) <= _tol(dtype) * float(want.abs().max())
	op = BSROperator(blocks, indices, indptr, (n, n))
	U = _cplx(cuda, (n, 13), dtype, seed=3)
	before = bsr.LAUNCHES["bsr_spmm"]
	got = op.rmatmat(U)
	assert bsr.LAUNCHES["bsr_spmm"] == before + 1
	want = op.rmatmat_plain(U)
	assert float((got - want).abs().max()) <= _tol(dtype) * float(want.abs().max())
	dense = op.todense().to(torch.complex128)
	assert float((got.to(torch.complex128) - dense.mH @ U.to(torch.complex128)).abs().max()) <= 10 * _tol(dtype) * float(want.abs().max())


def test_eigensolvers_and_bidiag_launch_the_kernels(cuda):
	from primate_tpu_torch import GramOperator, eigsh, lanczos_bidiag, svds

	n = 4000
	L = sps.diags([-np.ones(n - 1), 3.0 * np.ones(n), -np.ones(n - 1)], [-1, 0, 1]).tocsr()
	op = DIAOperator.from_scipy(L, dtype=torch.float64, device=cuda)
	ew = np.sort(3.0 - 2.0 * np.cos(np.arange(1, n + 1) * np.pi / (n + 1)))
	_common.reset_launches()
	w = eigsh(op, k=3, which="LA", seed=0, maxiter=500, return_eigenvectors=False)
	assert dia.LAUNCHES["dia_stencil"] > 0
	np.testing.assert_allclose(w.cpu().numpy(), ew[-3:], atol=1e-4)  # the top eigenvalues are 1e-6 apart
	_common.reset_launches()
	eigsh(op, k=3, which="LA", seed=0, method="trlan", return_eigenvectors=False)
	assert dia.LAUNCHES["dia_stencil_t"] > 0
	A = sps.random(3000, 700, density=0.01, random_state=np.random.default_rng(6), format="csr")
	X = BSROperator.from_scipy(A, blocksize=(8, 8), dtype=torch.float64, device=cuda)
	_common.reset_launches()
	s = svds(X, k=3, seed=0, return_vectors=False)
	assert bsr.LAUNCHES["bsr_spmm"] > 0
	np.testing.assert_allclose(np.sort(s.cpu().numpy()), np.sort(np.linalg.svd(A.toarray(), compute_uv=False))[-3:], rtol=1e-6)
	out = lanczos_bidiag(X, deg=20, seed=1)
	assert torch.all(torch.isfinite(out.alphas))
	assert GramOperator(X).matmat_t(torch.ones((2, 700), dtype=torch.float64, device=cuda)).shape == (2, 700)


# --- bfloat16: the four kernels at bf16 storage with float32 sums --------------------------------
#
# A bf16 output is held within one bf16 ulp of its largest entry (2^(⌊log2 max⌋ − 7)): the kernel and
# the plain version sum the same float32 products in other orders, and a sum within a float32 ulp of a
# bf16 rounding boundary may round the other way. Pass A's float32 w, unrounded, within 1e-5 of its
# largest entry; rounded, see _assert_rounded_pass_a. α within 1e-4 relative.
BF16 = torch.bfloat16


def _ulp_of_max(want) -> float:
	return 2.0 ** (math.floor(math.log2(float(want.float().abs().max()))) - 7)


def _assert_rounded_pass_a(v, bands, offs, q_cur, q_prev, beta):
	"""Rounded pass A against its plain version: every entry within 1e-5 of the largest, except flips (a
	stencil sum rounded to its other bf16 neighbour, one bf16 ulp of that sum away), at most 1e-4 of the
	entries; and v nearer the rounded plain version than the unrounded one, which a kernel that ignores
	the switch is not."""
	v_r, _ = dia.lanczos_dia_step_ref(bands, offs, q_cur, q_prev, beta)
	v_u, _ = dia.lanczos_dia_step_ref(bands, offs, q_cur, q_prev, beta, rounded=False)
	s = dia._stencil_t_acc(bands, offs, q_cur)
	d, tol = (v - v_r).abs(), 1e-5 * float(v_r.abs().max())
	flip = (d > tol) & (d <= torch.exp2(torch.floor(torch.log2(s.abs())) - 7) + tol)
	assert bool(torch.all((d <= tol) | flip)) and int(flip.sum()) <= 1e-4 * v.numel()
	assert float(d.double().mean()) < float((v - v_u).abs().double().mean())


@pytest.mark.parametrize("shape", SHAPES)
def test_bf16_kernels_match_plain_versions(cuda, shape):
	"""The probe-major stencil and pass A (rounded and not) in bf16 at the float32 shapes: more
	diagonals than one chunk (the float32 scratch), offsets of whole vectors and not, n below the
	offsets, and a misaligned block (the scalar path)."""
	bands, offs, x, q_cur, q_prev, beta = _inputs(cuda, *shape[:3], torch.float32, *shape[3:])
	bands, q_cur, q_prev = bands.to(BF16), q_cur.to(BF16), q_prev.to(BF16)
	lead = shape[3] if len(shape) > 3 else 0
	x = torch.empty(lead + x.numel(), device=cuda, dtype=BF16)[lead:].view(x.shape).copy_(x)
	before = dict(dia.LAUNCHES)
	got, want = dia.dia_stencil_t(bands, offs, x), dia.dia_stencil_t_ref(bands, offs, x)
	torch.cuda.synchronize()
	assert got.dtype == BF16 and dia.LAUNCHES["dia_stencil_t"] == before["dia_stencil_t"] + 1
	assert float((got.float() - want.float()).abs().max()) <= _ulp_of_max(want)
	for rounded in (True, False):
		v, alpha = dia.lanczos_dia_step(bands, offs, q_cur, q_prev, beta, rounded=rounded)
		v_ref, alpha_ref = dia.lanczos_dia_step_ref(bands, offs, q_cur, q_prev, beta, rounded=rounded)
		torch.cuda.synchronize()
		assert v.dtype == torch.float32 and alpha.dtype == torch.float32
		if rounded:
			_assert_rounded_pass_a(v, bands, offs, q_cur, q_prev, beta)
		else:
			assert float((v - v_ref).abs().max()) <= 1e-5 * float(v_ref.abs().max())
		assert float(((alpha - alpha_ref).abs() / alpha_ref.abs()).max()) <= 1e-4
	assert dia.LAUNCHES["lanczos_dia_step"] == before["lanczos_dia_step"] + 2


@pytest.mark.parametrize("shape", PADDED_SHAPES)
def test_bf16_pass_a_on_a_padded_carry(cuda, shape):
	"""Pass A unrounded on the bf16 padded carry (lo and ld whole 128-byte lines, 64 bf16; w float32
	of the same ld) against its plain version, on the vector path, margins of w exactly zero; with an
	identity ``reduce`` (the sharded operator's call) the same bit for bit."""
	nv, n, offsets = shape
	g = torch.Generator(device=cuda)
	g.manual_seed(13)
	spec = dia.carry_spec(n, max(abs(o) for o in offsets), 2)
	assert spec.lo % 64 == 0 and spec.ld % 64 == 0
	bands = spec.pad((torch.rand((len(offsets), n), generator=g, device=cuda) + 0.5).to(BF16))
	offs = torch.tensor(offsets, dtype=torch.int64, device=cuda)
	unit = lambda X: X / torch.linalg.vector_norm(X, dim=1, keepdim=True)  # noqa: E731
	q, qp = (spec.pad(unit(torch.randn((nv, n), generator=g, device=cuda)).to(BF16)) for _ in range(2))
	beta = torch.rand(nv, generator=g, device=cuda) + 0.5
	scalar = dict(_common.SCALAR_LAUNCHES)
	v, alpha = dia.lanczos_dia_step(bands, offs, q, qp, beta, spec, rounded=False)
	v_ref, alpha_ref = dia.lanczos_dia_step_ref(bands, offs, q, qp, beta, spec, rounded=False)
	torch.cuda.synchronize()
	assert _common.SCALAR_LAUNCHES == scalar
	assert not v[:, : spec.lo].any() and not v[:, spec.lo + n :].any()
	assert float((v - v_ref).abs().max()) <= 1e-5 * float(v_ref.abs().max())
	assert float(((alpha - alpha_ref).abs() / alpha_ref.abs()).max()) <= 1e-4
	v2, alpha2 = dia.lanczos_dia_step(bands, offs, q, qp, beta, spec, lambda t: t, rounded=False)
	assert torch.equal(v2, v) and torch.equal(alpha2, alpha)


@pytest.mark.parametrize("k", [1, 64, 65, 240])
@pytest.mark.parametrize("offsets", DIA_OFFSETS)
def test_bf16_dia_stencil_matches_plain_version(cuda, offsets, k):
	n = 12_000
	g = torch.Generator(device=cuda)
	g.manual_seed(k)
	bands = (torch.rand((len(offsets), n), generator=g, device=cuda) + 0.5).to(BF16)
	offs = torch.tensor(offsets, dtype=torch.int64, device=cuda)
	V = torch.randn((n, k), generator=g, device=cuda).to(BF16)
	before = dict(dia.LAUNCHES)
	got, want = dia.dia_stencil(bands, offs, V), dia.dia_stencil_ref(bands, offs, V)
	torch.cuda.synchronize()
	assert got.dtype == BF16 and dia.LAUNCHES["dia_stencil"] == before["dia_stencil"] + 1
	assert float((got.float() - want.float()).abs().max()) <= _ulp_of_max(want)


@pytest.mark.parametrize("k", [1, 5, 64, 240])
@pytest.mark.parametrize("tile", [(8, 16), (4, 4), (8, 8)])
def test_bf16_bsr_spmm_matches_plain_version(cuda, tile, k):
	blocks, indptr, indices, n = _bsr_arrays(cuda, BF16, *tile)
	g = torch.Generator(device=cuda)
	g.manual_seed(k)
	V = torch.randn((n, k), generator=g, device=cuda).to(BF16)
	before = dia.LAUNCHES["bsr_spmm"]
	got, want = bsr.bsr_spmm(blocks, indptr, indices, V, n), bsr.bsr_spmm_ref(blocks, indptr, indices, V, n)
	torch.cuda.synchronize()
	assert got.dtype == BF16 and dia.LAUNCHES["bsr_spmm"] == before + 1
	assert float((got.float() - want.float()).abs().max()) <= _ulp_of_max(want)
	assert float(got[3 * tile[0] : 4 * tile[0]].float().abs().max()) == 0.0  # the empty block row


def test_bf16_scalar_paths_for_a_misaligned_block(cuda):
	blocks, indptr, indices, n = _bsr_arrays(cuda, BF16, 8, 8)
	V = torch.randn(n * 64 + 1, device=cuda).to(BF16)[1:].view(n, 64)
	assert V.data_ptr() % 16 != 0
	bands = (torch.rand((3, n), device=cuda) + 0.5).to(BF16)
	offs = torch.tensor([-1, 0, 1], device=cuda)
	before = dict(_common.SCALAR_LAUNCHES)
	got_b, got_d = bsr.bsr_spmm(blocks, indptr, indices, V, n), dia.dia_stencil(bands, offs, V)
	torch.cuda.synchronize()
	assert _common.SCALAR_LAUNCHES["bsr_spmm"] == before["bsr_spmm"] + 1
	assert _common.SCALAR_LAUNCHES["dia_stencil"] == before["dia_stencil"] + 1
	for got, want in ((got_b, bsr.bsr_spmm_ref(blocks, indptr, indices, V, n)), (got_d, dia.dia_stencil_ref(bands, offs, V))):
		assert float((got.float() - want.float()).abs().max()) <= _ulp_of_max(want)


def test_bf16_stencil_gradient_matches_autograd_of_the_plain_version(cuda):
	"""The bf16 ``dia_stencil_t`` Function at the flagship's pattern (64 × 500k, 3 diagonals): its
	backward's adjoint apply is the bf16 kernel on the adjoint bands (one launch), its band gradient
	a float32 reduction rounded once. Autograd through the plain version adds each diagonal's bf16
	gradient in bf16, so the two are held within n_d bf16 ulps of the largest entry."""
	n, nv, offsets = 500_000, 64, (-1, 0, 1)
	g = torch.Generator(device=cuda)
	g.manual_seed(21)
	bands = (torch.rand((3, n), generator=g, device=cuda) + 0.5).to(BF16).requires_grad_()
	x = torch.randn((nv, n), generator=g, device=cuda).to(BF16).requires_grad_()
	G = torch.randn((nv, n), generator=g, device=cuda).to(BF16)
	offs = torch.tensor(offsets, device=cuda)
	before = dia.LAUNCHES["dia_stencil_t"]
	got = torch.autograd.grad(ptt_autograd.dia_stencil_t_ad(bands, x, offs, offsets), (bands, x), G)
	assert dia.LAUNCHES["dia_stencil_t"] == before + 2  # forward and the adjoint apply
	want = torch.autograd.grad(dia.dia_stencil_t_ref(bands, offs, x), (bands, x), G)
	torch.cuda.synchronize()
	for gv, wv in zip(got, want):
		assert gv.dtype == BF16
		assert float((gv.float() - wv.float()).abs().max()) <= len(offsets) * _ulp_of_max(wv)


def test_bf16_sweeps_on_the_card_match_the_cpu_port(cuda):
	"""``lanczos_block_op`` on a bf16 DIA operator, flat and ``phys=True``, on the card (pass A's
	bf16 kernel, rounded and not, and the round pair, once a step each; no pass B) against the CPU port
	on the same bf16 probes: α and β within 1e-3 relative (q is rounded to bf16 every step)."""
	n, nv = 20_001, 8
	L = sps.diags([-np.ones(n - 1), 3.0 * np.ones(n), -np.ones(n - 1)], [-1, 0, 1]).tocsr()
	V0 = torch.from_numpy(np.random.default_rng(6).choice([-1.0, 1.0], size=(n, nv))).to(BF16)
	for phys in (False, True):
		before = dict(dia.LAUNCHES)
		got = lanczos_block_op(DIAOperator.from_scipy(L, dtype=BF16, device=cuda), V0.to(cuda), deg=12, ncv=2, orth=0, return_basis=False, phys=phys)
		assert dia.LAUNCHES["lanczos_dia_step"] == before["lanczos_dia_step"] + 12
		assert dia.LAUNCHES["lanczos_dia_round"] == before["lanczos_dia_round"] + 12
		assert dia.LAUNCHES["lanczos_dia_residual"] == before["lanczos_dia_residual"]
		want = lanczos_block_op(DIAOperator.from_scipy(L, dtype=BF16, device="cpu"), V0, deg=12, ncv=2, orth=0, return_basis=False, phys=phys)
		for gv, wv in ((got.alphas, want.alphas), (got.betas, want.betas)):
			assert float((gv.cpu() - wv).abs().max() / wv.abs().max()) <= 1e-3


# --- bfloat16: the register kernels of pass A and the probe-major stencil ---------------------------
#
# (nv, n, offsets, lead). Neighbours from the lane's own rows and one word of the neighbouring lane's
# (±1, ±2; lanes 0 and 31 load that word), from one whole 16-byte vector (±8, ±1024), from two aligned
# vectors and a byte permute (±3 … ±7, ±9, ±100); more diagonals than a chunk of 8; n not a multiple of
# a tile of 2048 rows; probe counts past and below a group of 4; a block that starts one element into
# its buffer (the scalar path).
BF16_PASS_A_CASES = {
	"near": (64, 20_000, (-2, -1, 0, 1, 2), 0),
	"permute": (13, 5_000, (-7, -6, -5, -4, -3, 0, 3, 4, 5, 6, 7), 0),
	"whole": (7, 12_296, (-1024, -8, 0, 8, 1024), 0),
	"far": (9, 3_000, (-100, -9, 0, 9, 100), 0),
	"all_small": (5, 4_104, tuple(range(-9, 10)), 0),
	"single_probe": (1, 40_000, (-1, 0, 1), 0),
	"scalar_path": (13, 3_001, (-9, -2, -1, 0, 1, 2, 9), 1),
}


def _bf16_carry(dev, nv, n, lead, g):
	"""Unit rows in bf16, in a block that starts ``lead`` elements into its buffer."""
	X = torch.randn((nv, n), generator=g, device=dev)
	X = (X / torch.linalg.vector_norm(X, dim=1, keepdim=True)).to(BF16)
	return torch.empty(lead + nv * n, device=dev, dtype=BF16)[lead:].view(nv, n).copy_(X)


@pytest.mark.parametrize("rounded", [True, False], ids=["rounded", "unrounded"])
@pytest.mark.parametrize("case", list(BF16_PASS_A_CASES))
def test_bf16_pass_a_register_kernel(cuda, case, rounded):
	"""bf16 pass A through its wrapper against its plain version: rounded, every entry of w within 1e-5 of
	the largest but for one-ulp flips of the stencil sum on at most 1e-4 of the entries; unrounded, within
	1e-5; α within 1e-4 relative. One launch, on the scalar path only for the misaligned block."""
	nv, n, offsets, lead = BF16_PASS_A_CASES[case]
	g = torch.Generator(device=cuda)
	g.manual_seed(18)
	bands = (torch.rand((len(offsets), n), generator=g, device=cuda) + 0.5).to(BF16)
	offs = torch.tensor(offsets, dtype=torch.int64, device=cuda)
	q, qp = _bf16_carry(cuda, nv, n, lead, g), _bf16_carry(cuda, nv, n, lead, g)
	beta = torch.rand(nv, generator=g, device=cuda) + 0.5
	before, scalar = dict(_common.BF16_LAUNCHES), _common.SCALAR_LAUNCHES["lanczos_dia_step"]
	v, alpha = dia.lanczos_dia_step(bands, offs, q, qp, beta, rounded=rounded)
	torch.cuda.synchronize()
	assert _common.BF16_LAUNCHES["lanczos_dia_step"] == before["lanczos_dia_step"] + 1
	assert _common.SCALAR_LAUNCHES["lanczos_dia_step"] == scalar + (case == "scalar_path")
	v_ref, alpha_ref = dia.lanczos_dia_step_ref(bands, offs, q, qp, beta, rounded=rounded)
	if rounded:
		_assert_rounded_pass_a(v, bands, offs, q, qp, beta)
	else:
		assert float((v - v_ref).abs().max()) <= 1e-5 * float(v_ref.abs().max())
	assert float(((alpha - alpha_ref).abs() / alpha_ref.abs()).max()) <= 1e-4


@pytest.mark.parametrize("halo", [False, True], ids=["zero_margins", "halo_margins"])
@pytest.mark.parametrize("shape", PADDED_SHAPES)
def test_bf16_pass_a_finishing_mode_and_a_done_probe(cuda, shape, halo):
	"""bf16 pass A unrounded on the padded carry, launched as the sharded sweep launches it: in the finishing
	mode (the rank's α sums, the state left alone) and in the whole mode (the last block writes α to the
	state and to ``alpha_out``, zero for a probe that is done). With ``halo_margins`` the margins hold data, as
	after a halo exchange: the lanes past the own rows hold it for their neighbours. w's margins exactly zero."""
	from primate_tpu_torch.ops._build import load_library

	nv, n, offsets = shape
	g = torch.Generator(device=cuda)
	g.manual_seed(19)
	spec = dia.carry_spec(n, max(abs(o) for o in offsets), 2)
	bands = spec.pad((torch.rand((len(offsets), n), generator=g, device=cuda) + 0.5).to(BF16))
	offs = torch.tensor(offsets, dtype=torch.int64, device=cuda)
	q, qp = (spec.pad(_bf16_carry(cuda, nv, n, 0, g)) for _ in range(2))
	if halo:
		for X in (q, qp):
			X[:, : spec.lo] = (torch.randn((nv, spec.lo), generator=g, device=cuda) / n**0.5).to(BF16)
			X[:, spec.lo + n :] = (torch.randn((nv, spec.ld - spec.lo - n), generator=g, device=cuda) / n**0.5).to(BF16)
	beta = torch.rand(nv, generator=g, device=cuda) + 0.5
	v_ref, alpha_ref = dia.lanczos_dia_step_ref(bands, offs, q, qp, beta, spec, rounded=False)
	lib, tol = load_library(), 1e-5 * float(v_ref.abs().max())
	for finishing in (True, False):
		state = dia.lanczos_state(nv, torch.float32, cuda)
		state.scal[dia.BETA] = beta
		state.scal[dia.DONE, 0] = 1.0
		sums, alpha_out = torch.full((nv,), -1.0, device=cuda), torch.full((nv,), -1.0, device=cuda)
		scal0 = state.scal.clone()
		v, _, _, vec = dia._launch_pass_a(lib, bands, offs, q, qp, state.scal, state.ticket, None if finishing else alpha_out, spec,
			sums if finishing else None, rounded=False)
		torch.cuda.synchronize()
		assert vec and int(state.ticket) == 0
		assert not v[:, : spec.lo].any() and not v[:, spec.lo + n :].any()
		assert float((v - v_ref).abs().max()) <= tol
		if finishing:
			assert torch.equal(state.scal, scal0) and bool((alpha_out == -1).all())
			got = sums
		else:
			got = state.scal[dia.ALPHA]
			assert float(alpha_out[0]) == 0.0 and torch.equal(alpha_out[1:], got[1:]) and bool((sums == -1).all())
		assert float(((got - alpha_ref).abs() / alpha_ref.abs()).max()) <= 1e-4


# (nv, n, offsets, lead) for the bf16 probe-major stencil: one full chunk of 8 diagonals, and 9 (the second
# chunk starts from the float32 scratch), with neighbours of all three kinds; the flagship's 3 at a width
# that is not whole blocks of 2048 rows; the scalar path.
BF16_T_CASES = {
	"chunk_8": (13, 20_000, (-100, -9, -2, -1, 0, 1, 8, 100), 0),
	"chunks_9": (7, 12_008, (-100, -9, -8, -2, -1, 0, 1, 3, 100), 0),
	"flagship": (64, 30_000, (-1, 0, 1), 0),
	"chunk_8_scalar": (6, 3_000, (-100, -9, -2, -1, 0, 1, 8, 100), 1),
	"chunks_9_scalar": (5, 3_001, (-100, -9, -8, -2, -1, 0, 1, 3, 100), 0),
}


@pytest.mark.parametrize("case", list(BF16_T_CASES))
def test_bf16_stencil_t_register_kernel(cuda, case):
	"""bf16 ``dia_stencil_t`` against its plain version, within one bf16 ulp of the largest entry; one launch,
	on the scalar path only where n or the block's start rules out 16-byte vectors."""
	nv, n, offsets, lead = BF16_T_CASES[case]
	g = torch.Generator(device=cuda)
	g.manual_seed(20)
	bands = (torch.rand((len(offsets), n), generator=g, device=cuda) + 0.5).to(BF16)
	offs = torch.tensor(offsets, dtype=torch.int64, device=cuda)
	x = _bf16_carry(cuda, nv, n, lead, g)
	before, scalar = _common.BF16_LAUNCHES["dia_stencil_t"], _common.SCALAR_LAUNCHES["dia_stencil_t"]
	got = dia.dia_stencil_t(bands, offs, x)
	torch.cuda.synchronize()
	assert _common.BF16_LAUNCHES["dia_stencil_t"] == before + 1
	assert _common.SCALAR_LAUNCHES["dia_stencil_t"] == scalar + (lead > 0 or n % 8 != 0)
	want = dia.dia_stencil_t_ref(bands, offs, x)
	assert got.dtype == BF16 and float((got.float() - want.float()).abs().max()) <= _ulp_of_max(want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.complex64], ids=lambda v: str(v).replace("torch.", ""))
def test_other_dtypes_keep_their_pass_a_kernels(cuda, dtype):
	"""float32, float64 and complex64 pass A launch their own kernels (not the bf16 one) and, on a fixed
	small input whose every product and sum is exact (small integers, divisors powers of two), equal the plain
	pass A bit for bit: w, α, and ``alpha_out`` zero for the done probe."""
	from primate_tpu_torch.ops._build import load_library

	nv, n, offsets = 9, 512, (-9, -2, -1, 0, 1, 8, 100)  # every partial sum of α below 2^24 units of its last bit
	idx = torch.arange(nv * n, device=cuda, dtype=torch.int64)
	ints = lambda m, shift: ((idx * 7 + shift) % m - m // 2).to(torch.float64)  # noqa: E731
	part = lambda v: v.to(dtype) if not dtype.is_complex else torch.complex(v, ints(5, 3)[: v.numel()].view(v.shape)).to(dtype)  # noqa: E731
	v_cur, v_prev = part(ints(9, 1).view(nv, n)), part(ints(7, 2).view(nv, n))
	bands = part(ints(5, 4)[: len(offsets) * n].view(len(offsets), n))
	offs = torch.tensor(offsets, dtype=torch.int64, device=cuda)
	r = real_dtype(dtype)
	state = dia.lanczos_state(nv, r, cuda)
	state.scal[dia.DIV_CUR] = 2.0 ** torch.arange(nv, device=cuda, dtype=r).remainder(3)
	state.scal[dia.DIV_PREV] = 0.5
	state.scal[dia.BETA] = torch.arange(nv, device=cuda, dtype=r) - 4
	state.scal[dia.DONE, 2] = 1.0
	ref = dia.LanczosState(state.scal.clone(), state.ticket.clone())
	a, a_ref = torch.empty(nv, dtype=r, device=cuda), torch.empty(nv, dtype=r, device=cuda)
	before = dict(_common.BF16_LAUNCHES), dia.LAUNCHES["lanczos_dia_step"]
	w, _, _, vec = dia._launch_pass_a(load_library(), bands, offs, v_cur, v_prev, state.scal, state.ticket, a)
	w_ref = dia.lanczos_sweep_pass_a_ref(lambda q: dia.dia_stencil_t_ref(bands, offs, q), v_cur, v_prev, ref, a_ref)
	torch.cuda.synchronize()
	assert vec and _common.BF16_LAUNCHES == before[0] and dia.LAUNCHES["lanczos_dia_step"] == before[1] + 1
	assert torch.equal(w, w_ref) and torch.equal(state.scal, ref.scal) and torch.equal(a, a_ref) and float(a[2]) == 0.0


# --- bfloat16: the round pair that finishes a bf16 step after pass A ------------------------------
#
# (nv, n, max offset of the padded carry or None for the flat one, lead): probe counts past and below
# a block's 8, a padded carry of whole lines, a flat block of rows that are not whole vectors and one
# that starts one element into its buffer (both the scalar path). β' within 1e-6 relative; α outputs
# and the done flags equal; q_next equal but for flips of one bf16 ulp (a quotient within a float32 ulp
# of a rounding boundary), at most 1e-4 of the entries (each shape has 20,000 entries or more, so that
# share allows one).
ROUND_SHAPES = [(64, 20_000, None, 0), (13, 3001, 128, 0), (5, 4001, 7, 0), (7, 20_001, None, 0), (9, 12_000, None, 1)]


def _round_inputs(dev, nv, n, moff, lead, seed=31):
	"""A carry q (bf16), pass A's w and α (its plain version on the card), and a state in which probe 1
	was done before the step and probe 2 breaks down at it (w = 2·q, α = 2: v = 0 exactly)."""
	g = torch.Generator(device=dev)
	g.manual_seed(seed)
	spec = dia.carry_spec(n, moff, 2) if moff else dia.CarrySpec(n, 0, n)
	offsets = (-1, 0, 1) if not moff else (-moff, -1, 0, 1, moff)
	bands = spec.pad((torch.rand((len(offsets), n), generator=g, device=dev) + 0.5).to(BF16))
	offs = torch.tensor(offsets, dtype=torch.int64, device=dev)
	unit = lambda X: X / torch.linalg.vector_norm(X, dim=1, keepdim=True)  # noqa: E731
	q = torch.empty(lead + nv * spec.ld, device=dev, dtype=BF16)[lead:].view(nv, spec.ld).zero_()
	spec.rows(q).copy_(unit(torch.randn((nv, n), generator=g, device=dev)).to(BF16))
	qp = spec.pad(unit(torch.randn((nv, n), generator=g, device=dev)).to(BF16))
	beta = torch.rand(nv, generator=g, device=dev) + 0.5
	w, alpha = dia.lanczos_dia_step_ref(bands, offs, q, qp, beta, spec)
	w[2], alpha[2] = spec.zero_margins(2.0 * q[2].float()), 2.0
	state = dia.lanczos_state(nv, torch.float32, dev)
	state.scal[dia.ALPHA], state.scal[dia.BETA], state.scal[dia.DONE, 1] = alpha, beta, 1.0
	return spec, w, q, state


def _assert_round_matches(got, want, spec, label):
	(q_k, a_k, b_k, s_k), (q_r, a_r, b_r, s_r) = got, want
	assert torch.equal(a_k, a_r) and torch.equal(s_k[dia.DONE], s_r[dia.DONE]) and torch.equal(s_k[dia.ALPHA], s_r[dia.ALPHA])
	for k, r in ((b_k, b_r), (s_k[dia.BETA], s_r[dia.BETA]), (s_k[dia.DIV_CUR], s_r[dia.DIV_CUR])):
		fin = torch.isfinite(r)
		assert torch.equal(fin, torch.isfinite(k)) and torch.equal(k[~fin], r[~fin])
		assert bool(torch.all((k[fin] - r[fin]).abs() <= 1e-6 * r[fin].abs()))
	assert bool(torch.all(b_k[1] == 0)) and float(s_k[dia.DONE, 2]) == 1.0 and not q_k[2].any()
	assert not q_k[:, : spec.lo].any() and not q_k[:, spec.lo + spec.n :].any()
	d = (q_k.float() - q_r.float()).abs()
	ulp = torch.exp2(torch.floor(torch.log2(torch.maximum(q_k.float().abs(), q_r.float().abs()))) - 7)
	flips = int((d > 0).sum())
	print(f"{label}: {flips} of {q_k.numel()} entries of q_next one bf16 ulp from the plain version")
	assert bool(torch.all(d <= ulp)) and flips <= 1e-4 * q_k.numel()


@pytest.mark.parametrize("finishing", [False, True], ids=["whole", "finishing"])
@pytest.mark.parametrize("shape", ROUND_SHAPES)
def test_bf16_round_pair_matches_plain_version(cuda, shape, finishing):
	"""The round pair (B1 and B2, one launch of ``lanczos_dia_round``) against its plain version on the
	same pass A output: the flat and the padded carry, nv past and below 8, a misaligned block (its
	scalar path), a probe done before the step and one that breaks down at it; whole (B1's last block
	advances the state) and in the finishing mode (α from the reduced sums, Σv² through ``reduce``,
	B2 finishing the step from the sums: no advance kernel)."""
	nv, n, moff, lead = shape
	spec, w, q, state = _round_inputs(cuda, nv, n, moff, lead)
	tol = float(np.sqrt(n) * 1e-8)
	runs = []
	before, scalar = dict(dia.LAUNCHES), dict(_common.SCALAR_LAUNCHES)
	for fn in (dia.lanczos_dia_round, dia.lanczos_dia_round_ref):
		st = dia.LanczosState(state.scal.clone(), state.ticket.clone())
		a_out, b_out = torch.full((nv,), -1.0, device=cuda), torch.full((nv,), -1.0, device=cuda)
		kw = {}
		if finishing:
			sums = torch.stack([st.scal[dia.ALPHA], torch.zeros(nv, device=cuda)])
			st.scal[dia.ALPHA] = 7.0  # the finishing mode reads α from the sums
			kw = dict(reduce=lambda t: t, sums=sums)
		q_next = fn(w.clone(), q, st, a_out, b_out, tol, spec, **kw)
		torch.cuda.synchronize()
		runs.append((q_next, a_out, b_out, st.scal))
	assert dia.LAUNCHES["lanczos_dia_round"] == before["lanczos_dia_round"] + 1
	assert dia.LAUNCHES["lanczos_dia_advance"] == before["lanczos_dia_advance"]
	vec = _common.vector_ok(spec.ld, 2, w, q, lead=spec.lo)
	assert vec == (lead == 0 and n % 8 == 0 or moff is not None)
	assert _common.SCALAR_LAUNCHES["lanczos_dia_round"] == scalar["lanczos_dia_round"] + (not vec)
	assert int(runs[0][3][dia.DONE].sum()) == 2 and float(runs[0][1][2]) == 2.0
	_assert_round_matches(runs[0], runs[1], spec, f"{shape} {'finishing' if finishing else 'whole'}")


def test_round_pair_takes_bf16_only(cuda):
	spec, w, q, state = _round_inputs(cuda, 4, 1000, None, 0)
	out = torch.empty(4, device=cuda)
	with pytest.raises(TypeError, match="takes bfloat16; got torch.float32"):
		dia.lanczos_dia_round(w, q.float(), state, out, out.clone(), 1e-7)
	with pytest.raises(TypeError, match="float16"):
		dia.lanczos_dia_round(w, q.half(), state, out, out.clone(), 1e-7)
	with pytest.raises(TypeError, match="w has dtype"):
		dia.lanczos_dia_round(w.to(BF16), q, state, out, out.clone(), 1e-7)


# --- the node-major stencil in all five dtypes ---------------------------------------------------

NM_DTYPES = [torch.float32, torch.float64, BF16, torch.complex64, torch.complex128]
# Max-abs error over max|out| against the plain version on the card: the real kernels contract each
# multiply-add where the plain version rounds the product first; complex64 is held bit for bit.
NM_TOL = {torch.float32: 1e-5, torch.float64: 1e-12, BF16: None, torch.complex64: 0.0, torch.complex128: 1e-14}


def _nm_inputs(dev, n, k, offsets, dtype, lead=0, seed=0):
	g = torch.Generator(device=dev)
	g.manual_seed(seed)
	real = dtype.to_real() if dtype.is_complex else torch.float32 if dtype == BF16 else dtype

	def draw(shape):
		if dtype.is_complex:
			return torch.complex(torch.randn(shape, generator=g, device=dev, dtype=real), torch.randn(shape, generator=g, device=dev, dtype=real))
		return torch.randn(shape, generator=g, device=dev, dtype=real).to(dtype)

	bands = draw((len(offsets), n))
	V = draw((lead + n * k,))[lead:].view(n, k)
	return bands, torch.tensor(offsets, dtype=torch.int64, device=dev), V


def _nm_close(got, want, dtype, label=""):
	torch.cuda.synchronize()
	assert got.dtype == dtype and got.shape == want.shape
	if dtype == torch.complex64:
		assert torch.equal(torch.view_as_real(got), torch.view_as_real(want)), f"complex64 not bit for bit: {label}"
		return
	tol = _ulp_of_max(want) if dtype == BF16 else NM_TOL[dtype] * float(want.abs().max())
	diff = got - want if dtype.is_complex else got.double() - want.double()
	assert float(diff.abs().max()) <= tol, label


def _nm_widths():
	"""(dtype, k): every width of the spec, on the vector path where k is a whole number of 16-byte
	vectors and on the element path otherwise."""
	return [(dtype, k) for dtype in NM_DTYPES for k in (1, 3, 63, 64, 65, 240)]


@pytest.mark.parametrize("dtype,k", _nm_widths(), ids=lambda v: str(v).replace("torch.", ""))
def test_node_major_kernel_at_every_width(cuda, dtype, k):
	"""The kernel against ``dia_stencil_ref`` at n = 3001 (a ragged last block of rows): offsets near
	(±1, ±3, 0), at and one past ±40, far (−200) and the wrap offsets near ±n, 12 diagonals (three batches
	of loads), and at 9 and 17 diagonals."""
	n, reach = 3001, 40
	for offsets in ((-(n - 2), -5 * reach, -reach - 1, -reach, -3, -1, 0, 1, 3, reach, reach + 1, n - 2),
			(-2049, -2048, -100, -1, 0, 1, 100, 2048, 2049), tuple(range(-8, 9))):
		bands, offs, V = _nm_inputs(cuda, n, k, offsets, dtype, seed=k)
		vec = _common.vector_ok(k, V.element_size(), V)
		assert vec == (k % (16 // V.element_size()) == 0)
		scalar = _common.SCALAR_LAUNCHES["dia_stencil"]
		got = dia.dia_stencil(bands, offs, V)
		assert _common.SCALAR_LAUNCHES["dia_stencil"] == scalar + (not vec)
		_nm_close(got, dia.dia_stencil_ref(bands, offs, V), dtype, f"{offsets}")


NM_CASES = {
	# n smaller than a block's rows; offsets past n
	"n_below_a_block": (50, (-60, -7, -1, 0, 1, 7, 49, 60)),
	"nine_diagonals": (4099, (-2049, -2048, -100, -1, 0, 1, 100, 2048, 2049)),
	"seventeen_diagonals": (5000, tuple(range(-8, 9))),
	# the Hofstadter lattice's offsets (ny = 2048) at a cut n: ±1, ±2047, ±2048 and the wrap ±(n − 2048)
	"hofstadter_cut": (12 * 2048, (-(12 * 2048 - 2048), -2048, -2047, -1, 1, 2047, 2048, 12 * 2048 - 2048)),
}


@pytest.mark.parametrize("dtype", NM_DTYPES, ids=lambda v: str(v).replace("torch.", ""))
@pytest.mark.parametrize("case", list(NM_CASES))
@pytest.mark.parametrize("k", [1, 64, 65])
def test_node_major_stencil_cases(cuda, case, k, dtype):
	"""``dia_stencil`` against ``dia_stencil_ref``, and once more on a block one element into its buffer
	(the element path where a vector holds more than one element)."""
	n, offsets = NM_CASES[case]
	for lead in (0, 1):
		bands, offs, V = _nm_inputs(cuda, n, k, offsets, dtype, lead=lead, seed=7)
		before, scalar = dia.LAUNCHES["dia_stencil"], _common.SCALAR_LAUNCHES["dia_stencil"]
		got = dia.dia_stencil(bands, offs, V)
		assert dia.LAUNCHES["dia_stencil"] == before + 1
		assert _common.SCALAR_LAUNCHES["dia_stencil"] == scalar + (not _common.vector_ok(k, V.element_size(), V))
		_nm_close(got, dia.dia_stencil_ref(bands, offs, V), dtype, f"{case} lead {lead}")


# --- the row-sharded step's finish folded into the next kernel, and complex128 bsr_spmm's L2 path ----

# (nv, n, offsets, padded): the flat carry and the padded one, nv past a probe group.
FINISH_SHAPES = [(64, 20_000, (-1, 0, 1), False), (13, 3001, (-128, -17, 0, 16, 128), True)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", FINISH_SHAPES)
def test_pass_a_runs_the_pending_finish(cuda, shape, dtype):
	"""Pass A with a row-sharded step's finish pending (``lanczos_dia_step_finish``): from a mid-sweep state (a
	probe done before the step, one whose β' falls below the tolerance in it) and seeded reduced sums, its last
	block writes what ``lanczos_dia_advance_ref`` writes (the state and the step's outputs, bit for bit), its
	blocks take the divisors and β of that finish (``w`` equal, bit for bit, to pass A launched after the
	standalone advance kernel), and its α sums match the plain pass A after the plain finish."""
	nv, n, offsets, padded = shape
	tol_v, tol_a = TOL[dtype]
	g = torch.Generator(device=cuda)
	g.manual_seed(31)
	spec = dia.carry_spec(n, max(abs(o) for o in offsets), torch.empty((), dtype=dtype).element_size()) if padded else dia.CarrySpec(n, 0, n)
	bands = spec.pad(torch.rand((len(offsets), n), generator=g, device=cuda, dtype=dtype) + 0.5)
	offs = torch.tensor(offsets, dtype=torch.int64, device=cuda)
	carry = lambda: spec.pad(torch.randn((nv, n), generator=g, device=cuda, dtype=dtype) / n**0.5)  # noqa: E731
	v_cur, v_prev = carry(), carry()
	tol = 1e-6
	prev = torch.stack([torch.randn(nv, generator=g, device=cuda, dtype=dtype), torch.rand(nv, generator=g, device=cuda, dtype=dtype) + 0.5])
	prev[1, 2] = 1e-14  # probe 2: β' below the tolerance, so its divisor turns inf
	from primate_tpu_torch.ops._build import load_library

	lib = load_library()
	runs = []
	for mode in ("folded", "advance_then_pass_a", "plain"):
		st = _step_state(cuda, nv, dtype, torch.Generator(device=cuda).manual_seed(32))
		ab = torch.full((2, nv), -1.0, dtype=dtype, device=cuda)
		fin = dia.Finish(prev.clone(), ab[0], ab[1], tol)
		sums = torch.empty((2, nv), dtype=dtype, device=cuda)
		if mode == "plain":
			dia.lanczos_dia_advance_ref(fin.sums, st, fin.alpha_out, fin.beta_out, tol)
			w, alpha = dia._pass_a_plain(lambda q: dia.dia_stencil_t_ref(bands, offs, q), v_cur, v_prev, st.scal, lambda t: t, spec)
			sums[0] = alpha
		else:
			if mode == "advance_then_pass_a":
				dia._launch_advance(lib, fin.sums, st, fin.alpha_out, fin.beta_out, tol)
			before = dict(dia.LAUNCHES)
			w = dia._launch_pass_a(lib, bands, offs, v_cur, v_prev, st.scal, st.ticket, None, spec, sums[0],
				pending=fin if mode == "folded" else None)[0]
			assert dia.LAUNCHES["lanczos_dia_step"] == before["lanczos_dia_step"] + 1
			assert dia.LAUNCHES["lanczos_dia_advance"] == before["lanczos_dia_advance"]
		torch.cuda.synchronize()
		runs.append((w, sums[0].clone(), ab, st.scal))
	(w_f, s_f, ab_f, st_f), (w_a, s_a, ab_a, st_a), (w_p, s_p, ab_p, st_p) = runs
	assert torch.equal(st_f, st_p) and torch.equal(ab_f, ab_p) and torch.equal(st_f, st_a) and torch.equal(ab_f, ab_a)
	assert torch.equal(w_f, w_a) and torch.equal(s_f, s_a)
	assert float(st_f[dia.DONE, 2]) == 1.0 and ab_f[0, 0] == 0 and ab_f[1, 0] == 0 and math.isinf(float(st_f[dia.DIV_CUR, 2]))
	assert float((w_f - w_p).abs().max()) <= tol_v * float(w_p.abs().max())
	assert float(((s_f - s_p).abs() / s_p.abs().clamp_min(1e-30)).max()) <= tol_a


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.bfloat16])
def test_row_sharded_sweep_takes_the_unsharded_launches(cuda, dtype):
	"""A 12-step sweep in the row-sharded mode (an identity ``reduce``) on the padded carry: float32/float64 launch
	pass A and pass B a step and the advance kernel once, for the finish of the last step (``lanczos_dia_finish``),
	and α and β match the eager plain sweep; bfloat16 launches pass A and the round pair a step and no advance
	kernel (B2 finishes each step), α and β matching the plain bf16 step."""
	nv, n, deg, offsets = 16, 50_000, 12, (-1, 0, 1)
	g = torch.Generator(device=cuda)
	g.manual_seed(33)
	acc = torch.float32 if dtype == torch.bfloat16 else dtype
	spec = dia.carry_spec(n, 1, torch.empty((), dtype=dtype).element_size())
	bands = spec.pad((torch.rand((3, n), generator=g, device=cuda) + 0.5).to(dtype))
	offs = torch.tensor(offsets, dtype=torch.int64, device=cuda)
	X = torch.randn((nv, n), generator=g, device=cuda)
	q0 = spec.pad((X / torch.linalg.vector_norm(X, dim=1, keepdim=True)).to(dtype))
	same = lambda t: t  # noqa: E731
	outs = []
	for kernels in (True, False):
		state = dia.lanczos_state(nv, acc, cuda)
		ab = torch.empty((2, deg, nv), dtype=acc, device=cuda)
		prev, cur = torch.zeros_like(q0), q0
		dia.reset_launches()
		for j in range(deg):
			if dtype == torch.bfloat16:
				step = dia.lanczos_dia_round_step if kernels else _plain_round_step
				prev, cur = cur, step(bands, offs, cur, prev, state, ab[0, j], ab[1, j], 1e-8, spec, reduce=same)
			elif kernels:
				prev, cur = cur, dia.lanczos_dia_sweep_step(bands, offs, cur, prev, state, ab[0, j], ab[1, j], 1e-8, spec, same)
			else:
				apply_ref = lambda q: dia.dia_stencil_t_ref(bands, offs, q)  # noqa: E731
				prev, cur = cur, dia.lanczos_sweep_step_ref(apply_ref, cur, prev, state, ab[0, j], ab[1, j], 1e-8, same, spec)
		dia.lanczos_dia_finish(state)
		torch.cuda.synchronize()
		counts = {k: dia.LAUNCHES[k] for k in ("lanczos_dia_step", "lanczos_dia_residual", "lanczos_dia_round", "lanczos_dia_advance")}
		outs.append(ab)
		if kernels:
			bf = dtype == torch.bfloat16
			assert counts == {"lanczos_dia_step": deg, "lanczos_dia_residual": 0 if bf else deg, "lanczos_dia_round": deg if bf else 0,
				"lanczos_dia_advance": 0 if bf else 1}
	tol = 1e-3 if dtype == torch.bfloat16 else TOL[dtype][1]
	assert float(((outs[0] - outs[1]).abs() / outs[1].abs()).max()) <= tol


def _plain_round_step(bands, offs, q_cur, q_prev, state, alpha_out, beta_out, tol, spec, reduce):
	"""The bf16 row-sharded step as plain PyTorch ops: pass A's plain version, then the round pair's in one piece."""
	w, alpha = dia.lanczos_dia_step_ref(bands, offs, q_cur, q_prev, state.scal[dia.BETA], spec, reduce)
	sums = torch.stack([alpha, torch.empty_like(alpha)])
	return dia.lanczos_dia_round_ref(w, q_cur, state, alpha_out, beta_out, tol, spec, reduce, sums)


# (n, k, lead): complex128 with 8x8 tiles where V fits in L2: odd k, k of one column group and of several chunks, an
# empty block row (every case), and V starting one element into its buffer (still 16-byte aligned: a complex128
# tensor cannot start between two of its elements' 8-byte halves).
L2_CASES = [(1001, 1, 0), (1001, 3, 0), (1001, 8, 0), (1001, 33, 0), (1001, 64, 0), (1001, 65, 1), (4099, 240, 0)]


@pytest.mark.parametrize("n,k,lead", L2_CASES)
def test_complex128_bsr_spmm_l2_path(cuda, n, k, lead):
	"""Complex128 ``bsr_spmm`` on its L2 path (float64 MMAs, ``L2_LAUNCHES``) against ``bsr_spmm_ref`` within
	complex128's tolerance (the MMA's sum order), the empty block row exactly zero."""
	blocks, indptr, indices, n = _cplx_bsr(cuda, torch.complex128, 8, 8, n=n)
	V = _cplx(cuda, (n * k + lead,), torch.complex128, seed=k)[lead:].view(n, k)
	before, l2 = bsr.LAUNCHES["bsr_spmm"], _common.L2_LAUNCHES["bsr_spmm"]
	got = bsr.bsr_spmm(blocks, indptr, indices, V, n)
	assert bsr.LAUNCHES["bsr_spmm"] == before + 1 and _common.L2_LAUNCHES["bsr_spmm"] == l2 + 1
	want = bsr.bsr_spmm_ref(blocks, indptr, indices, V, n)
	torch.cuda.synchronize()
	assert float((got - want).abs().max()) <= CPLX_TOL[torch.complex128] * float(want.abs().max())
	assert float(got[3 * 8 : 4 * 8].abs().max()) == 0.0


def test_complex128_bsr_spmm_l2_path_hub_row_and_cell(cuda):
	"""The L2 path at phase 21's shape (``block_random_spd(8192)`` with seeded imaginary tiles, k = 64) and on a
	block row of 3,000 tiles among short and empty ones; a V past the L2 threshold (the same tiles at k = 320, 42 MB)
	and 4x4 tiles take the ring kernel; each against ``bsr_spmm_ref`` within complex128's tolerance of its largest
	entry, but the hub row within that tolerance of the largest entry of ``|A|·|V|``: its entries sum 24,000 products,
	whose rounding in any two orders differs by about 1e-14 of the largest entry (the plain version's ``index_add_``
	takes its own order from run to run), and ``|A|·|V|`` is the scale that rounding is bounded by."""
	S = chip_smoke._bsr_cell(n=chip_smoke.CBSR_C128_N, bs=8, density=0.01, seed=chip_smoke.CBSR_SEED)
	A = BSROperator.from_scipy(S, blocksize=(8, 8), dtype=torch.float64, device=cuda)
	g = torch.Generator(device=cuda)
	g.manual_seed(34)
	blocks = torch.complex(A.blocks, torch.randn(A.blocks.shape, generator=g, device=cuda, dtype=torch.float64))
	rng = np.random.default_rng(35)
	counts = rng.integers(0, 4, 2000)
	counts[::7] = 0
	counts[1234] = 3000
	hub_indptr = torch.tensor(np.concatenate([[0], np.cumsum(counts)]), dtype=torch.int64, device=cuda)
	hub_indices = torch.tensor(rng.integers(0, 2000, int(counts.sum())), dtype=torch.int64, device=cuda)
	hub = _cplx(cuda, (int(counts.sum()), 8, 8), torch.complex128, seed=36)
	small = _cplx_bsr(cuda, torch.complex128, 4, 4)
	cases = [("cell", blocks, A.indptr, A.indices, A.shape[0], 64, 1), ("hub", hub, hub_indptr, hub_indices, 16_000, 65, 1),
		("past_l2", blocks, A.indptr, A.indices, A.shape[0], 320, 0), ("tiles_4x4", *small[:3], small[3], 64, 0)]
	for label, bl, ip, ix, n, k, l2 in cases:
		V = _cplx(cuda, (n, k), torch.complex128, seed=37)
		before = _common.L2_LAUNCHES["bsr_spmm"]
		got = bsr.bsr_spmm(bl, ip, ix, V, n)
		assert _common.L2_LAUNCHES["bsr_spmm"] == before + l2, label
		want = bsr.bsr_spmm_ref(bl, ip, ix, V, n)
		scale = bsr.bsr_spmm_ref(bl.abs(), ip, ix, V.abs(), n) if label == "hub" else want
		torch.cuda.synchronize()
		assert float((got - want).abs().max()) <= CPLX_TOL[torch.complex128] * float(scale.abs().max()), label


# The CGS window's chain (ops.cgs, csrc/cgs_window.cu) against its plain version, the PyTorch ops the sweep ran,
# for every (carry, window, q_cur) dtype the kernels take (ops.cgs.COMBOS): the window in the sweep's dtype, a
# bfloat16 window summed in float32 (a float32 sweep's basis_dtype, and a bfloat16 sweep's window and q_cur), a
# float16 window summed in float32 (a real sweep's basis_dtype), and a window of another width (basis_dtype). Tolerance, by the carry's dtype, max |Δv| over max |v| and the relative
# error of Σ|v|²: the dots, the slot sum of the update and Σ|v|² are sums in another order than PyTorch's;
# everything else rounds as PyTorch rounds it: float32 and complex64 carries 1e-5, float64 and complex128 1e-12, a
# few units of their rounding over n = 4,096 and three passes. The α step is held bit for bit, and two runs of
# the chain give the same bits.
F16, F32, F64, C64, C128 = torch.float16, torch.float32, torch.float64, torch.complex64, torch.complex128
CGS_CASES = {
	"float32": (F32, F32, F32), "float64": (F64, F64, F64), "complex64": (C64, C64, C64), "complex128": (C128, C128, C128),
	"bf16_window": (F32, BF16, F32), "bf16_sweep": (F32, BF16, BF16), "bf16_sweep_f32_window": (F32, F32, BF16),
	"f32_f64_window": (F32, F64, F32), "bf16_sweep_f64_window": (F32, F64, BF16), "f64_f32_window": (F64, F32, F64),
	"f64_bf16_window": (F64, BF16, F64), "c64_c128_window": (C64, C128, C64), "c128_c64_window": (C128, C64, C128),
	"f16_window": (F32, F16, F32), "bf16_sweep_f16_window": (F32, F16, BF16), "f64_f16_window": (F64, F16, F64),
}
CGS_TOL = {F32: 1e-5, F64: 1e-12, C64: 1e-5, C128: 1e-12}


def _cgs_inputs(dev, case, ncv, nv=6, n=4096, seed=0):
	carry, win, qdt = CGS_CASES[case]
	g = torch.Generator(device=dev)
	g.manual_seed(seed)
	unit = lambda X: X / torch.linalg.vector_norm(X, dim=-1, keepdim=True)  # noqa: E731
	Q = unit(torch.randn((ncv, nv, n), generator=g, device=dev, dtype=carry)).to(win)
	v = torch.randn((nv, n), generator=g, device=dev, dtype=carry)
	alpha = torch.randn(nv, generator=g, device=dev, dtype=real_dtype(carry))
	q = unit(torch.randn((nv, n), generator=g, device=dev, dtype=carry)).to(qdt)
	return Q, v, alpha, q


def _cgs_close(got_v, want_v, got_sq, want_sq):
	torch.cuda.synchronize()
	tol = CGS_TOL[want_v.dtype]
	assert float((got_v - want_v).abs().max()) <= tol * float(want_v.abs().max())
	assert float(((got_sq - want_sq).abs() / want_sq).max()) <= tol


@pytest.mark.parametrize("passes", [1, 2, 3])
@pytest.mark.parametrize("ncv", [2, 5, 20])
@pytest.mark.parametrize("case", list(CGS_CASES))
def test_cgs_window_chain_matches_the_pytorch_window(cuda, case, ncv, passes):
	"""Every step j of a window that fills (orth = min(5, ncv) and the full window: the partial masks), and
	the selective mask, with q_cur taken from the window's slot where it is stored in q_cur's dtype (else
	from q_cur's rows), and the continuation without the α step that selective re-orthogonalisation runs;
	on the vector path, one launch counted a step."""
	Q, v0, alpha, q_rows = _cgs_inputs(cuda, case, ncv)
	window = cgs.CgsWindow(Q)
	before, scalar = _common.LAUNCHES["cgs_window"], _common.SCALAR_LAUNCHES["cgs_window"]
	calls = 0
	for j in range(ncv + 2):
		slot = j % ncv if Q.dtype == q_rows.dtype else -1
		q = Q[slot] if slot >= 0 else q_rows
		for mask in (cgs.slot_mask(j, min(5, ncv), ncv), cgs.slot_mask(j, ncv, ncv), cgs.slot_mask(j, 0, ncv, selective=True)):
			got_v, want_v = v0.clone(), v0.clone()
			got = window(got_v, mask, passes, alpha, None if slot >= 0 else q, slot)
			want = cgs.cgs_window_ref(want_v, Q, mask, passes, alpha, q)
			_cgs_close(got_v, want_v, got, want)
			got, want = window(got_v, mask, passes), cgs.cgs_window_ref(want_v, Q, mask, passes)
			_cgs_close(got_v, want_v, got, want)
			calls += 1
	assert _common.LAUNCHES["cgs_window"] == before + calls and _common.SCALAR_LAUNCHES["cgs_window"] == scalar


@pytest.mark.parametrize("case", list(CGS_CASES))
def test_cgs_window_alpha_step_is_bit_for_bit(cuda, case):
	"""``v −= α·q`` equals ``addcmul_`` bit for bit: alone (q from q_cur's rows, with Σ|v|²), and in the first
	kernel of the chain with q taken from the window's slot where it is stored in q_cur's dtype (its dots then
	within the tolerance of the sums)."""
	Q, v0, alpha, q = _cgs_inputs(cuda, case, 5)
	window = cgs.CgsWindow(Q)
	want_v = v0.addcmul(alpha[:, None], q.to(v0.dtype), value=-1)
	got_v = v0.clone()
	sq = window(got_v, 0, 2, alpha, q)
	torch.cuda.synchronize()
	assert torch.equal(got_v, want_v)
	assert float(((sq - dia.row_sq_norm(want_v)).abs() / sq).max()) <= CGS_TOL[v0.dtype]
	if Q.dtype == q.dtype:
		slot = 3
		want_v = v0.addcmul(alpha[:, None], Q[slot].to(v0.dtype), value=-1)
		got_v = v0.clone()
		launch, vec = window._launcher(got_v, alpha, Q[slot], slot)
		proj = torch.full((5, Q.shape[1]), float("nan"), dtype=torch.promote_types(v0.dtype, Q.dtype), device=cuda)
		launch(cgs.slot_groups(cgs.slot_mask(4, 5, 5), 5, slot)[0], alpha, proj_out=proj)
		torch.cuda.synchronize()
		assert vec and torch.equal(got_v, want_v)
		want = torch.sum((Q.conj() if Q.is_complex() else Q).to(proj.dtype) * want_v[None], dim=2)
		assert float((proj - want).abs().max()) <= CGS_TOL[v0.dtype] * float(want.abs().max()) * 10


@pytest.mark.parametrize("case", ["float32", "complex128", "bf16_sweep"])
def test_cgs_window_runs_twice_to_the_same_bits(cuda, case):
	"""The sums across blocks are finished in a fixed order: the same inputs give the same bits, with a
	window of more slots than one launch holds too (the split chain)."""
	for ncv in (5, 20):
		Q, v0, alpha, q = _cgs_inputs(cuda, case, ncv, seed=ncv)
		window = cgs.CgsWindow(Q)
		mask = cgs.slot_mask(ncv + 1, ncv, ncv)
		runs = []
		for _ in range(2):
			v = v0.clone()
			runs.append((v, window(v, mask, 2, alpha, q)))
		torch.cuda.synchronize()
		assert torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1])


@pytest.mark.parametrize("case", list(CGS_CASES))
def test_cgs_window_scalar_path(cuda, case):
	"""A length that is no whole number of 16-byte vectors (n = 4,001) and a carry that starts one element into
	its buffer take the element loads, counted in ``SCALAR_LAUNCHES`` (a complex128 carry keeps its vectors where every
	operand's do); the same tolerance."""
	for n, lead in ((4001, 0), (4096, 1)):
		Q, v0, alpha, q = _cgs_inputs(cuda, case, 5, n=n, seed=n + lead)
		# A thread's rows are whole 16-byte vectors of every operand: a length or a start that is no whole number of
		# them takes the element loads (a complex128 carry one element into its buffer still starts on a vector).
		elems = max(16 // t.element_size() for t in (v0, Q, q))
		scalar_path = n % elems != 0 or lead * v0.element_size() % 16 != 0
		buf = torch.zeros(lead + v0.numel(), dtype=v0.dtype, device=cuda)
		got_v = buf[lead:].view(v0.shape)
		got_v.copy_(v0)
		want_v = v0.clone()
		window = cgs.CgsWindow(Q)
		mask = cgs.slot_mask(6, 5, 5)
		scalar = _common.SCALAR_LAUNCHES["cgs_window"]
		got = window(got_v, mask, 2, alpha, q)
		want = cgs.cgs_window_ref(want_v, Q, mask, 2, alpha, q)
		_cgs_close(got_v, want_v, got, want)
		assert _common.SCALAR_LAUNCHES["cgs_window"] == scalar + scalar_path


@pytest.mark.parametrize("case", ["float32", "float64", "bf16_sweep"])
def test_cgs_window_on_a_padded_carry(cuda, case):
	"""The rows of a padded carry (``dia.carry_spec``: ``lo`` and ``ld`` whole 128-byte lines) at their row
	stride, no copy: the vector path, the rows as the plain version's, the margins left as they were."""
	nv, n = 6, 4096
	Q, v0, alpha, q = _cgs_inputs(cuda, case, 5, nv=nv, n=n, seed=7)
	spec = dia.carry_spec(n, 3, v0.element_size())
	carry = torch.full((nv, spec.ld), 7.0, dtype=v0.dtype, device=cuda)
	rows = spec.rows(carry)
	rows.copy_(v0)
	assert rows.stride(0) == spec.ld != n
	want_v = v0.clone()
	window = cgs.CgsWindow(Q)
	mask = cgs.slot_mask(6, 5, 5)
	scalar = _common.SCALAR_LAUNCHES["cgs_window"]
	got = window(rows, mask, 2, alpha, q)
	want = cgs.cgs_window_ref(want_v, Q, mask, 2, alpha, q)
	_cgs_close(rows, want_v, got, want)
	assert _common.SCALAR_LAUNCHES["cgs_window"] == scalar
	assert bool((carry[:, : spec.lo] == 7).all()) and bool((carry[:, spec.lo + n :] == 7).all())


# Re-orthogonalised sweeps on the card against the same sweep on the CPU (the PyTorch window): α and β,
# relative to max |α|, |β|. (dtype, keywords, tolerance[, operator]; a DIA operator where none is named: pass A a
# step; a CSR one: the plain step, whose complex α is the real view of a complex sum; a FunctionOperator around the
# DIA apply: the plain step, whose v is column-major).
REORTH_SWEEPS = {
	"f64_orth5": (F64, dict(orth=5, ncv=5), 1e-10),
	"f64_full20": (F64, dict(orth=20, ncv=20, reorth_passes=3), 1e-10),
	"f64_basis": (F64, dict(orth=5, ncv=20, return_basis=True), 1e-10),
	"f64_selective": (F64, dict(ncv=20, selective=True), 1e-10),
	"f32_orth5": (F32, dict(orth=5, ncv=5), 1e-4),
	"f32_phys": (F32, dict(orth=5, ncv=5, phys=True), 1e-4),
	"f32_bf16_basis": (F32, dict(orth=5, ncv=5, basis_dtype=torch.bfloat16), 1e-4),
	"f32_f16_basis": (F32, dict(orth=5, ncv=5, basis_dtype=torch.float16), 1e-4),
	"f64_f16_basis": (F64, dict(orth=5, ncv=5, basis_dtype=torch.float16), 1e-10),
	"c128_orth5": (C128, dict(orth=5, ncv=5), 1e-10),
	"c64_orth5": (C64, dict(orth=5, ncv=5), 1e-4),
	"f32_csr_orth5": (F32, dict(orth=5, ncv=5), 1e-4, CSROperator.from_scipy),
	"c64_csr_orth5": (C64, dict(orth=5, ncv=5), 1e-4, CSROperator.from_scipy),
	"c128_csr_selective": (C128, dict(ncv=20, selective=True), 1e-10, CSROperator.from_scipy),
	"f32_function_orth5": (F32, dict(orth=5, ncv=5), 1e-4, lambda L, **kw: _function_op(DIAOperator.from_scipy(L, **kw))),
	"c64_function_basis": (C64, dict(orth=5, ncv=5, return_basis=True), 1e-4, lambda L, **kw: _function_op(DIAOperator.from_scipy(L, **kw))),
}


def _function_op(D):
	"""``D`` seen only through its node-major apply: the plain step, around two transposes."""
	return FunctionOperator(D.matmat, D.shape, dtype=D.dtype, device=D.device)


@pytest.mark.parametrize("name", list(REORTH_SWEEPS))
def test_reorthogonalised_sweep_on_the_card_matches_the_cpu(cuda, name):
	"""``lanczos_block_op`` at ``orth > 0`` (or selective) on a DIA operator (pass A and the chain a step on the
	card), a CSR one or a FunctionOperator (the plain step and the chain), the same start block; α and β against the
	CPU sweep's."""
	dtype, kw, tol, *kind = REORTH_SWEEPS[name]
	build = kind[0] if kind else DIAOperator.from_scipy
	n = 3000
	L = sps.diags([-np.ones(n - 1), 3.0 * np.ones(n), -np.ones(n - 1)], [-1, 0, 1]).tocsr()
	V0 = torch.from_numpy(np.random.default_rng(5).standard_normal((n, 8)))
	if dtype.is_complex:
		L = L.astype(np.complex128)
		V0 = V0 + 1j * torch.from_numpy(np.random.default_rng(6).standard_normal((n, 8)))
	outs = []
	for dev in (cuda, "cpu"):
		op = build(L, device=dev, dtype=dtype)
		before = _common.LAUNCHES["cgs_window"]
		out = lanczos_block_op(op, V0.to(dtype).to(dev), deg=20, **kw)
		outs.append(out)
		if dev == cuda:
			assert _common.LAUNCHES["cgs_window"] == before + 20
	(a, b), (a_ref, b_ref) = ((o.alphas.cpu(), o.betas.cpu()) for o in outs)
	assert float((a - a_ref).abs().max()) <= tol * float(a_ref.abs().max())
	assert float((b - b_ref).abs().max()) <= tol * float(b_ref.abs().max())
