"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips without a CUDA device. Imports no JAX (the
card's machine has none). Run on the card with
``python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_cuda_kernels.py``.
"""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

from primate_tpu_torch import BSROperator, DIAOperator, MatrixFunction, hutch, lanczos_block_op, xtrace
from primate_tpu_torch.operators.base import LinearOperator
from primate_tpu_torch.ops import _common, bsr, dia
from primate_tpu_torch.ops import autograd as ptt_autograd

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


def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
	bands, offs, x, q_cur, q_prev, beta = _inputs(cuda, 4, 100, (-1, 0, 1), torch.float32)
	with pytest.raises(TypeError):
		dia.dia_stencil_t(bands, offs, x.double())
	with pytest.raises(TypeError):
		dia.dia_stencil_t(bands.bfloat16(), offs, x.bfloat16())
	c64 = torch.complex64
	with pytest.raises(NotImplementedError):  # the step kernels are real only (the stencils take complex)
		dia.lanczos_dia_step(bands.to(c64), offs, q_cur.to(c64), q_prev.to(c64), beta)
	with pytest.raises(TypeError):
		dia.dia_stencil_t(bands.to(c64), offs, x)
	with pytest.raises(ValueError, match="contiguous"):
		dia.dia_stencil_t(bands, offs, torch.randn((100, 4), device=cuda).T)
	with pytest.raises(ValueError):
		dia.lanczos_dia_step(bands, offs.cpu(), q_cur, q_prev, beta)


def test_slq_on_the_card_matches_the_cpu_port(cuda):
	"""The whole slice, f64, the same numpy probes on both devices."""
	n = 5000
	L = sps.diags([-np.ones(n - 1), 3.0 * np.ones(n), -np.ones(n - 1)], [-1, 0, 1]).tocsr()

	def sampler():
		rng = np.random.default_rng(3)
		return lambda size: rng.choice([-1.0, 1.0], size=size)

	kw = dict(fun="log", deg=20, orth=0)
	dia.reset_launches()
	got = hutch(MatrixFunction(DIAOperator.from_scipy(L, device=cuda), **kw), batch=16, converge="count", count=32, pdf=sampler())
	assert dia.LAUNCHES["lanczos_dia_step"] == dia.LAUNCHES["lanczos_dia_residual"] == 20 * 2
	want = hutch(MatrixFunction(DIAOperator.from_scipy(L, device="cpu"), **kw), batch=16, converge="count", count=32, pdf=sampler())
	np.testing.assert_allclose(got, want, rtol=1e-10)


# Awkward shapes of the sparse kernels: non-square and small tiles, an empty block
# row, n not a multiple of bm, one column, k past one block of threads; DIA offsets
# of ±10,000 on a short n. Tolerance: max-abs error over max|out|.
SPARSE_TOL = {torch.float32: 1e-5, torch.float64: 1e-12}


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
	for bad in (torch.complex64, torch.bfloat16):
		with pytest.raises((TypeError, NotImplementedError)):
			bsr.bsr_spmm(blocks.to(bad), indptr, indices, V.to(bad), n)
	with pytest.raises(TypeError):
		bsr.bsr_spmm(blocks, indptr, indices, V.double(), n)
	with pytest.raises(ValueError, match="contiguous"):
		bsr.bsr_spmm(blocks, indptr, indices, torch.randn((4, n), device=cuda).T, n)
	with pytest.raises(ValueError):
		bsr.bsr_spmm(blocks, indptr.cpu(), indices, V, n)
	op = BSROperator(blocks.to(torch.complex64), indices, indptr, (n, n))
	with pytest.raises(NotImplementedError):
		op.matmat(V.to(torch.complex64))
	bands = torch.ones((3, 100), device=cuda)
	offs = torch.tensor([-1, 0, 1], device=cuda)
	with pytest.raises(TypeError):
		dia.dia_stencil(bands.bfloat16(), offs, torch.ones((100, 3), device=cuda, dtype=torch.bfloat16))


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
	blocks.requires_grad_(True)
	Vb = rnd(n_bsr, k).requires_grad_(True)
	return [
		("dia_stencil_t", lambda b, v: kad.dia_stencil_t_ad(b, v, offs, offsets), lambda b, v: dia.dia_stencil_t_ref(b, offs, v), (bands, x), rnd(k, n_dia)),
		("dia_stencil", lambda b, v: kad.dia_stencil_ad(b, v, offs, offsets), lambda b, v: dia.dia_stencil_ref(b, offs, v), (bands, V), rnd(n_dia, k)),
		("bsr_spmm", lambda b, v: kad.bsr_spmm_ad(b, v, indptr, indices, n_bsr), lambda b, v: bsr.bsr_spmm_ref(b, indptr, indices, v, n_bsr),
			(blocks, Vb), rnd(n_bsr, k)),
	]


def test_kernel_functions_pass_gradcheck(cuda):
	"""float64 at small shapes: each Function's backward (kernels on the adjoint structure,
	PyTorch parameter reductions) against finite differences."""
	for name, fn, _, inputs, _ in _functions(cuda, torch.float64, 61, 45, 3, (-9, -1, 0, 2, 30), density=0.05):
		before = dia.LAUNCHES[name]
		assert torch.autograd.gradcheck(fn, inputs, eps=1e-6, atol=1e-8, rtol=1e-6), name
		assert dia.LAUNCHES[name] > before


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_backward_matches_autograd_of_the_plain_versions(cuda, dtype):
	"""The FEM cell's DIA pattern at n = 1M (7 diagonals to ±10,000, 64 probes) and 8×8 BSR
	tiles on n = 200,003 (a ragged last block): input and parameter gradients within 1e-5
	(float32) or 1e-12 (float64) of the largest entry of the plain version's autograd; each
	backward launches its kernel once, for the adjoint apply."""
	cases = _functions(cuda, dtype, 1_000_000, 200_003, 64, (-10_000, -100, -1, 0, 1, 100, 10_000), density=1e-4)
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


def test_complex_operators_on_the_card(cuda):
	"""A Hermitian DIA operator's Lanczos sweep takes the complex stencil and no step kernel and
	matches the CPU port; a complex BSR apply and a complex kernel backward raise."""
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
	assert dia.LAUNCHES["dia_stencil_t"] == 20 and dia.LAUNCHES["lanczos_dia_step"] == dia.LAUNCHES["lanczos_dia_residual"] == 0
	want = lanczos_block_op(op_cpu, torch.tensor(V0), deg=20, ncv=2, orth=0, return_basis=False)
	np.testing.assert_allclose(out.alphas.cpu().numpy(), want.alphas.numpy(), rtol=0, atol=1e-12)
	np.testing.assert_allclose(out.betas.cpu().numpy(), want.betas.numpy(), rtol=0, atol=1e-12)
	blocks, indptr, indices, n = _bsr_arrays(cuda, torch.float64, 8, 8)
	with pytest.raises(NotImplementedError):
		BSROperator(blocks.to(torch.complex128), indices, indptr, (n, n)).matmat(torch.ones((n, 2), device=cuda, dtype=torch.complex128))
	bands = op.bands.clone().requires_grad_(True)
	y = ptt_autograd.dia_stencil_t_ad(bands, torch.tensor(V0.T.copy(), device=cuda), op.offsets_t, op.offsets)
	with pytest.raises(NotImplementedError):
		torch.autograd.grad(y, bands, torch.ones_like(y))


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
