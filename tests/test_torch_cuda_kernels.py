"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips without a CUDA device. Imports no JAX (the
card's machine has none). Run on the card with
``python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_cuda_kernels.py``.
"""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

from primate_tpu_torch import BSROperator, DIAOperator, MatrixFunction, hutch, xtrace
from primate_tpu_torch.ops import bsr, dia

torch.set_num_threads(1)
pytestmark = pytest.mark.cuda

SHAPES = [(64, 20_000, (-1, 0, 1)), (13, 3001, (-200, -7, 0, 7, 200)), (1, 5, (-9, 0, 2))]
# Stencil: max-abs error over max|out|. α: relative, since the summation orders differ.
TOL = {torch.float32: (1e-5, 1e-4), torch.float64: (1e-12, 1e-10)}


@pytest.fixture
def cuda():
	if not torch.cuda.is_available():
		pytest.skip("needs a CUDA device")
	return torch.device("cuda", 0)


def _inputs(dev, nv, n, offsets, dtype, seed=0):
	g = torch.Generator(device=dev)
	g.manual_seed(seed)
	bands = torch.rand((len(offsets), n), generator=g, device=dev, dtype=dtype) + 0.5
	offs = torch.tensor(offsets, dtype=torch.int64, device=dev)
	unit = lambda X: X / torch.linalg.vector_norm(X, dim=1, keepdim=True)  # noqa: E731
	x = torch.randn((nv, n), generator=g, device=dev, dtype=dtype)
	q_cur = unit(torch.randn((nv, n), generator=g, device=dev, dtype=dtype))
	q_prev = unit(torch.randn((nv, n), generator=g, device=dev, dtype=dtype))
	beta = torch.rand(nv, generator=g, device=dev, dtype=dtype) + 0.5
	return bands, offs, x, q_cur, q_prev, beta


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", SHAPES)
def test_kernels_match_plain_versions(cuda, shape, dtype):
	tol_s, tol_a = TOL[dtype]
	bands, offs, x, q_cur, q_prev, beta = _inputs(cuda, *shape, dtype)
	before = dict(dia.LAUNCHES)
	got, want = dia.dia_stencil_t(bands, offs, x), dia.dia_stencil_t_ref(bands, offs, x)
	v, alpha = dia.lanczos_dia_step(bands, offs, q_cur, q_prev, beta)
	v_ref, alpha_ref = dia.lanczos_dia_step_ref(bands, offs, q_cur, q_prev, beta)
	torch.cuda.synchronize()
	assert dia.LAUNCHES["dia_stencil_t"] == before["dia_stencil_t"] + 1
	assert dia.LAUNCHES["lanczos_dia_step"] == before["lanczos_dia_step"] + 1
	assert float((got - want).abs().max()) <= tol_s * float(want.abs().max())
	assert float((v - v_ref).abs().max()) <= tol_s * float(v_ref.abs().max())
	assert float(((alpha - alpha_ref).abs() / alpha_ref.abs()).max()) <= tol_a


def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
	bands, offs, x, q_cur, q_prev, beta = _inputs(cuda, 4, 100, (-1, 0, 1), torch.float32)
	with pytest.raises(TypeError):
		dia.dia_stencil_t(bands, offs, x.double())
	with pytest.raises(TypeError):
		dia.dia_stencil_t(bands.bfloat16(), offs, x.bfloat16())
	with pytest.raises(NotImplementedError):
		dia.dia_stencil_t(bands.to(torch.complex64), offs, x.to(torch.complex64))
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
	assert dia.LAUNCHES["lanczos_dia_step"] == 20 * 2
	want = hutch(MatrixFunction(DIAOperator.from_scipy(L), **kw), batch=16, converge="count", count=32, pdf=sampler())
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
@pytest.mark.parametrize("k", [1, 130, 720])
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
@pytest.mark.parametrize("k", [1, 130, 720])
def test_dia_stencil_matches_plain_version(cuda, k, dtype):
	n, offsets = 12_000, (-10_000, -7, 0, 3, 10_000)
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
	for bad in (torch.complex64, torch.bfloat16):
		with pytest.raises((TypeError, NotImplementedError)):
			dia.dia_stencil(bands.to(bad), offs, torch.ones((100, 3), device=cuda, dtype=bad))


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
