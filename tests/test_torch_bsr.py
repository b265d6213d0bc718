"""The port's BSR SpMM and BSROperator against the JAX package.

Inputs are made with numpy from a seed and handed to both packages. On the CPU
the port's ``bsr_spmm`` runs its plain PyTorch version; the JAX side runs its
Pallas kernel in interpret mode (``bsr_matmat(..., interpret=True)``) and its
XLA path (``_matmat_jnp``), as the JAX package's own tests do. Tolerance: 1e-10
absolute in float64, where both sides only reorder the same sums.
"""

import warnings

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import jax.numpy as jnp

from primate_tpu.operators.sparse import BSROperator as JaxBSR
from primate_tpu.ops.spmm_pallas import bsr_matmat
from primate_tpu_torch import BSROperator, bsr_from_numpy
from primate_tpu_torch.operators.base import quad_form
from primate_tpu_torch.ops import _common
from primate_tpu_torch.ops.bsr import bsr_spmm, bsr_spmm_ref

torch.set_num_threads(1)
ATOL = 1e-10


def _random_sym(n, density, seed):
	A = sps.random(n, n, density=density, random_state=np.random.default_rng(seed), format="csr")
	return (A + A.T).tocsr()


def _empty_rows():
	# Block rows 1 (rows 8..15) entirely zero: its output tile must come out zero.
	A = np.zeros((32, 32))
	A[:8, :8] = np.arange(64).reshape(8, 8)
	A[16:, 16:] = 1.0
	return sps.csr_matrix(A)


# The cases of tests/test_pallas.py:24-66, as (matrix, blocksize, k); k = 0 is a single vector.
CASES = {
	"4x4": (lambda: _random_sym(64, 0.05, 0), (4, 4), 8),
	"8x8": (lambda: _random_sym(64, 0.05, 0), (8, 8), 8),
	"8x16": (lambda: _random_sym(64, 0.05, 0), (8, 16), 8),
	"empty_block_rows": (_empty_rows, (8, 8), 4),
	"single_vector": (lambda: _random_sym(48, 0.1, 7), (8, 8), 0),
	"k130": (lambda: _random_sym(64, 0.08, 9), (8, 8), 130),
	"n_not_multiple_of_bm": (lambda: _random_sym(45, 0.1, 3), (8, 8), 5),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_matmat_matches_jax_pallas_and_xla(case):
	make, blocksize, k = CASES[case]
	A = make()
	with warnings.catch_warnings():
		warnings.simplefilter("ignore")  # scattered patterns warn about fill-in on both sides
		jop = JaxBSR.from_scipy(A, blocksize=blocksize, engine="scipy")
		op = BSROperator.from_scipy(A, blocksize=blocksize)
	n = A.shape[0]
	rng = np.random.default_rng(11)
	V = rng.normal(size=n) if k == 0 else rng.normal(size=(n, k))
	got = op.matmat(torch.from_numpy(V)).numpy() if k else op.matvec(torch.from_numpy(V)).numpy()
	assert got.shape == V.shape
	np.testing.assert_allclose(got, np.asarray(bsr_matmat(jop, jnp.asarray(V), interpret=True)), rtol=0, atol=ATOL)
	V2 = V[:, None] if k == 0 else V
	np.testing.assert_allclose(got.reshape(V2.shape), np.asarray(jop._matmat_jnp(jnp.asarray(V2))), rtol=0, atol=ATOL)
	np.testing.assert_allclose(got, A @ V, rtol=0, atol=ATOL)
	if case == "empty_block_rows":
		assert np.all(got[8:16] == 0.0)


def test_rmatmat_todense_and_quad_form_match_jax():
	A = sps.random(40, 40, density=0.1, random_state=np.random.default_rng(2), format="csr")  # non-symmetric
	with warnings.catch_warnings():
		warnings.simplefilter("ignore")
		jop = JaxBSR.from_scipy(A, blocksize=(8, 8), engine="scipy")
		op = BSROperator.from_scipy(A, blocksize=(8, 8))
	V = np.random.default_rng(3).normal(size=(40, 6))
	np.testing.assert_allclose(op.rmatmat(torch.from_numpy(V)).numpy(), np.asarray(jop.rmatmat(jnp.asarray(V))), rtol=0, atol=ATOL)
	np.testing.assert_allclose(op.rmatvec(torch.from_numpy(V[:, 0])).numpy(), A.T @ V[:, 0], rtol=0, atol=ATOL)
	np.testing.assert_array_equal(op.todense().numpy(), np.asarray(jop.todense()))
	np.testing.assert_array_equal(op.todense().numpy(), A.toarray())
	np.testing.assert_allclose(quad_form(op, torch.from_numpy(V)).numpy(), (V * (A @ V)).sum(axis=0), rtol=0, atol=ATOL)
	assert op.pshape == jop.pshape and op.blocksize == jop.blocksize and op.nnz == jop.nnz


def test_kernel_wrapper_plain_version_against_jax_flat_kernel():
	"""bsr_spmm on raw arrays vs the Pallas kernel on the same arrays, f32 and f64."""
	A = _random_sym(56, 0.1, 5)
	for dtype, atol in ((np.float32, 1e-5), (np.float64, ATOL)):
		jop = JaxBSR.from_scipy(A.astype(dtype), blocksize=(8, 8), engine="scipy")
		V = np.random.default_rng(6).normal(size=(56, 7)).astype(dtype)
		blocks, indices, indptr = (torch.tensor(np.asarray(x)) for x in (jop.blocks, jop.indices, jop.indptr))
		got = bsr_spmm(blocks, indptr.long(), indices.long(), torch.from_numpy(V), 56)
		assert got.dtype == torch.from_numpy(V).dtype
		want = np.asarray(bsr_matmat(jop, jnp.asarray(V), interpret=True))
		np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=atol)


def test_from_numpy_of_a_jax_operator():
	with warnings.catch_warnings():
		warnings.simplefilter("ignore")
		jop = JaxBSR.from_scipy(_random_sym(50, 0.1, 4), blocksize=(8, 8))
	op = bsr_from_numpy(np.asarray(jop.blocks), np.asarray(jop.indices), np.asarray(jop.indptr), jop.shape, dtype=torch.float64)
	assert op.shape == tuple(jop.shape) and op.blocksize == (8, 8)
	np.testing.assert_array_equal(op.todense().numpy(), np.asarray(jop.todense()))
	V = np.random.default_rng(1).normal(size=(50, 3))
	np.testing.assert_allclose(op.matmat(torch.from_numpy(V)).numpy(), np.asarray(jop.matmat(jnp.asarray(V))), rtol=0, atol=ATOL)


def test_fill_in_warning_and_layout_copies():
	with pytest.warns(UserWarning, match="block-structured"):
		BSROperator.from_scipy(sps.identity(64, format="csr"), blocksize=(16, 16))
	op = BSROperator.from_dense(np.eye(16) * 2.0, blocksize=(8, 8))
	_common.reset_launches()
	Vt = torch.randn(3, 16, dtype=torch.float64)
	torch.testing.assert_close(op.matmat(Vt.T), 2.0 * Vt.T)  # probe-major: one counted copy
	op.matmat(torch.randn(16, 3, dtype=torch.float64))  # node-major: none
	assert _common.LAYOUT_COPIES["bsr_spmm"] == 1 and _common.LAUNCHES["bsr_spmm"] == 0  # CPU: the plain version


def test_plain_version_chunks_over_tiles(monkeypatch):
	"""A tile chunk smaller than the operator gives the same product."""
	A = _random_sym(64, 0.1, 8)
	op = BSROperator.from_scipy(A, blocksize=(4, 4))
	V = torch.from_numpy(np.random.default_rng(9).normal(size=(64, 5)))
	whole = bsr_spmm_ref(op.blocks, op.indptr, op.indices, V, 64)
	import primate_tpu_torch.ops.bsr as bsr_mod

	monkeypatch.setattr(bsr_mod, "_REF_CHUNK_ELEMS", 4 * 5 * 3)  # three tiles per chunk
	torch.testing.assert_close(bsr_spmm_ref(op.blocks, op.indptr, op.indices, V, 64), whole, rtol=0, atol=ATOL)


def test_wrapper_rejects_tensors_off_cpu_and_cuda():
	blocks = torch.ones((2, 8, 8), device="meta")
	idx = torch.zeros(2, dtype=torch.int64, device="meta")
	ptr = torch.tensor([0, 2], device="meta")
	with pytest.raises(ValueError, match="CUDA"):
		bsr_spmm(blocks, ptr, idx, torch.empty((8, 3), device="meta"), 8)
	with pytest.raises(ValueError, match="n_out"):
		bsr_spmm(torch.ones((2, 8, 8)), torch.tensor([0, 2]), torch.zeros(2, dtype=torch.int64), torch.ones((8, 3)), 9)
