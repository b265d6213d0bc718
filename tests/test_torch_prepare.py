"""The native sparse-prep loader, ``auto_operator`` and the adjoint applies of the port
against the JAX package, float64 unless a case says otherwise: the port's C++ converters
give the arrays of ``primate_tpu.native`` and of scipy's route, bit for bit; both
``from_scipy`` engines store the same bands and tiles; ``auto_operator`` makes the choices
(format, permutation, bandwidth, fill) the JAX package makes on the counterparts of
``tests/test_prepare.py``'s cases; the DIA and BSR adjoint applies through the kernel
wrappers (their plain versions here) equal the plain PyTorch adjoints and the dense
product; the operator algebra carries rectangular factors and their adjoints."""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import jax.numpy as jnp

from primate_tpu import native as jax_native
from primate_tpu.operators import auto_operator as jax_auto
from primate_tpu.operators.prepare import _analyze as jax_analyze

import primate_tpu_torch as ptt
from primate_tpu_torch import native
from primate_tpu_torch.operators import (
	BSROperator,
	CSROperator,
	DenseOperator,
	DIAOperator,
	GramOperator,
	auto_operator,
	bandwidth,
	reorder_rcm,
)
from primate_tpu_torch.operators.prepare import _analyze

torch.set_num_threads(1)
CPU = dict(device="cpu")
pytestmark = pytest.mark.filterwarnings("ignore:BSROperator tiles")


def _rand_csr(n, m, density, seed, dtype=np.float64):
	return sps.random(n, m, density=density, random_state=np.random.default_rng(seed), format="csr").astype(dtype)


def banded(n: int, seed: int = 0) -> sps.csr_matrix:
	rng = np.random.default_rng(seed)
	off = rng.uniform(-1.0, -0.5, n - 1)
	return sps.diags([off, rng.uniform(2.0, 3.0, n), off], [-1, 0, 1]).tocsr()


def shuffled(A, seed: int = 1):
	p = np.random.default_rng(seed).permutation(A.shape[0])
	return A[p][:, p].tocsr()


# --- the native loader ---


def test_the_library_builds_here_outside_the_nvcc_sweep():
	from primate_tpu_torch.ops import _build

	assert native.available()
	assert native.library_path().parent.name == "_build"
	assert all(p.suffix == ".cu" for p in _build._sources())


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("shape,bs", [((64, 64), (8, 8)), ((70, 70), (4, 4)), ((70, 45), (8, 16)), ((96, 96), (8, 8))])
def test_native_bsr_arrays_equal_jax_native(shape, bs, dtype):
	A = _rand_csr(*shape, 0.07, seed=1, dtype=dtype)
	if shape == (96, 96):  # empty block rows: the loader's coverage tiles
		A = A.tolil()
		A[16:40] = 0
		A = A.tocsr()
		A.eliminate_zeros()
	got, want = native.csr_to_bsr_arrays(A, *bs), jax_native.csr_to_bsr_arrays(A, *bs)
	for g, w in zip(got, want):
		assert g.dtype == w.dtype and np.array_equal(g, w)


def test_native_dia_arrays_and_analysis_equal_jax_native():
	n = 120
	A = sps.diags([np.arange(1, n - 4, dtype=float), np.ones(n), -np.ones(n - 1)], [5, 0, -1]).tocsr()
	(o1, b1), (o2, b2) = native.csr_to_dia_arrays(A), jax_native.csr_to_dia_arrays(A)
	assert o1 == o2 and np.array_equal(b1, b2)
	rng = np.random.default_rng(17)
	for shape, density in [((300, 300), 0.01), ((200, 120), 0.03), ((64, 64), 0.2)]:
		B = sps.random(*shape, density=density, random_state=rng, format="csr")
		assert native.csr_analyze(B, 8, 8) == jax_native.csr_analyze(B, 8, 8)
		assert _analyze(B, (8, 8)) == jax_analyze(B, (8, 8))


def test_complex_values_take_the_scipy_route():
	A = (_rand_csr(40, 40, 0.1, seed=2) * (1 + 1j)).tocsr()
	assert native.csr_to_dia_arrays(A) is None and native.csr_to_bsr_arrays(A, 8, 8) is None
	op = DIAOperator.from_scipy(A, **CPU)
	assert op.dtype == torch.complex128
	np.testing.assert_array_equal(op.todense().numpy(), A.toarray())
	with pytest.raises(TypeError, match="real values"):
		DIAOperator.from_scipy(A, engine="native", **CPU)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("shape,bs", [((64, 64), (8, 8)), ((70, 70), (4, 4)), ((70, 45), (8, 16)), ((96, 96), (8, 8))])
def test_both_bsr_engines_store_the_same_tiles(shape, bs, dtype):
	A = _rand_csr(*shape, 0.07, seed=3, dtype=dtype)
	A = A + A  # duplicates summed the same way by both
	if shape == (96, 96):
		A = A.tolil()
		A[16:40] = 0
		A = A.tocsr()
		A.eliminate_zeros()
	nat = BSROperator.from_scipy(A, blocksize=bs, engine="native", **CPU)
	sp = BSROperator.from_scipy(A, blocksize=bs, engine="scipy", **CPU)
	for key in ("blocks", "indices", "indptr"):
		assert torch.equal(getattr(nat, key), getattr(sp, key)), key
	np.testing.assert_array_equal(nat.todense().numpy(), A.toarray())
	assert (torch.diff(nat.indptr) == 0).any() == (shape == (96, 96))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_both_dia_engines_store_the_same_bands(dtype):
	n = 120
	A = sps.diags([np.arange(1, n - 4, dtype=float), np.ones(n), -np.ones(n - 1), np.full(n - 60, 0.5)], [5, 0, -1, -60]).tocsr().astype(dtype)
	nat = DIAOperator.from_scipy(A, engine="native", **CPU)
	sp = DIAOperator.from_scipy(A, engine="scipy", **CPU)
	assert nat.offsets == sp.offsets and torch.equal(nat.bands, sp.bands)
	np.testing.assert_array_equal(nat.todense().numpy(), A.toarray())


def test_bsr_auto_takes_scipys_route(monkeypatch):
	def refuse(*args, **kw):
		raise AssertionError("engine='auto' reached the native BSR converter")

	monkeypatch.setattr(native, "csr_to_bsr_arrays", refuse)
	A = _rand_csr(70, 45, 0.08, seed=7)
	op = BSROperator.from_scipy(A, blocksize=(8, 8), **CPU)
	sp = BSROperator.from_scipy(A, blocksize=(8, 8), engine="scipy", **CPU)
	assert all(torch.equal(getattr(op, k), getattr(sp, k)) for k in ("blocks", "indices", "indptr"))


def test_engine_native_raises_the_compilers_error(monkeypatch):
	monkeypatch.setattr(native, "_STATE", {"error": RuntimeError("g++ failed (1): sparse_prep.cpp:1: error: expected")})
	assert not native.available()
	A = banded(50)
	with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
		DIAOperator.from_scipy(A, engine="native", **CPU)
	with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
		BSROperator.from_scipy(A, blocksize=(8, 8), engine="native", **CPU)
	# "auto" takes scipy's route; the analysis falls back to numpy.
	assert DIAOperator.from_scipy(A, **CPU).offsets == (-1, 0, 1)
	assert _analyze(A)["bandwidth"] == 1
	with pytest.raises(ValueError):
		DIAOperator.from_scipy(A, engine="fast", **CPU)


# --- auto_operator against the JAX package ---


def _same_choice(A, **kw):
	op, info = auto_operator(A, **kw, **CPU)
	jop, jinfo = jax_auto(A, **kw)
	assert info.format == jinfo.format
	assert info.bandwidth == jinfo.bandwidth
	assert info.fill == pytest.approx(jinfo.fill, rel=1e-12)
	assert (info.perm is None) == (jinfo.perm is None)
	if info.perm is not None:
		assert np.array_equal(info.perm, jinfo.perm)
	assert tuple(op.shape) == tuple(jop.shape)
	return op, info


@pytest.mark.parametrize("case", ["natural_band", "shuffled_band", "never", "scattered", "dense_small", "dense_density",
	"dense_array", "rectangular", "always"])
def test_auto_operator_makes_jax_choices(case):
	rng = np.random.default_rng(2)
	kw = {}
	if case == "natural_band":
		A, want = banded(900), DIAOperator
	elif case == "shuffled_band":
		A, want = shuffled(banded(700, seed=5), seed=7), DIAOperator
	elif case == "never":
		A, want, kw = shuffled(banded(700), seed=11), CSROperator, {"reorder": "never"}
	elif case == "scattered":
		A = sps.random(1500, 1500, density=0.002, random_state=4, format="csr")
		A, want = (A + A.T).tocsr(), CSROperator
	elif case == "dense_small":
		A, want = banded(100), DenseOperator
	elif case == "dense_density":
		A, want = sps.random(700, 700, density=0.3, random_state=6, format="csr"), DenseOperator
	elif case == "dense_array":
		A, want = rng.normal(size=(60, 60)), DenseOperator
	elif case == "rectangular":
		A, want = sps.random(900, 600, density=0.004, random_state=7, format="csr"), CSROperator
	else:
		n, k = 2000, 30
		rows, cols = [], []
		for i in range(n):
			js = i + rng.choice(np.arange(1, k), size=3, replace=False)
			js = js[js < n]
			rows.extend([i] * len(js))
			cols.extend(js.tolist())
		B = sps.coo_matrix((np.ones(len(rows)), (rows, cols)), shape=(n, n))
		A = shuffled((B + B.T + sps.eye(n) * 4).tocsr(), seed=11)
		want, kw = (CSROperator, BSROperator), {"reorder": "always", "dia_fill_limit": 1.01}
	op, info = _same_choice(A, **kw)
	assert isinstance(op, want)
	v = rng.normal(size=A.shape[1])
	got = info.unpermute(op.matvec(torch.from_numpy(info.permute(v))).numpy())
	np.testing.assert_allclose(got, A @ v, atol=1e-10)


def test_auto_block_pattern_is_bsr():
	rng = np.random.default_rng(2)
	nb, b = 40, 8
	mask = rng.random((nb, nb)) < 0.06
	mask |= mask.T
	np.fill_diagonal(mask, True)
	A = sps.csr_matrix(np.kron(mask, np.ones((b, b))) * rng.normal(size=(nb * b, nb * b)))
	op, info = _same_choice(A, dense_density=0.5, dense_n=64)
	assert info.format == "bsr" and isinstance(op, BSROperator) and info.fill <= 1.5
	v = rng.normal(size=nb * b)
	np.testing.assert_allclose(op.matvec(torch.from_numpy(v)).numpy(), A @ v, atol=1e-8)


def test_prep_bookkeeping_rcm_bandwidth_and_trace():
	A = shuffled(banded(640), seed=13)
	op, info = auto_operator(A, dtype=torch.float64, **CPU)
	assert info.perm is not None and info.bandwidth <= 2
	X = np.random.default_rng(3).normal(size=(640, 5))
	np.testing.assert_allclose(info.unpermute(info.permute(X)), X)
	np.testing.assert_allclose(info.unpermute(info.permute(X.T, axis=1), axis=1), X.T)
	Xt = torch.from_numpy(X)
	assert torch.equal(info.unpermute(info.permute(Xt)), Xt)
	assert bandwidth(A) > 1 and bandwidth(banded(600)) == 1 and bandwidth(sps.eye(10).tocsr()) == 0
	B, perm = reorder_rcm(A)
	np.testing.assert_array_equal(B.toarray(), A.toarray()[perm][:, perm])
	est = ptt.hutch(op, converge="count", count=256, seed=0)
	assert abs(est - A.diagonal().sum()) <= 10 / np.sqrt(640) * np.sqrt(A.diagonal().sum())
	with pytest.raises(ValueError):
		auto_operator(banded(700), reorder="sometimes", **CPU)
	with pytest.raises(ValueError):
		reorder_rcm(sps.random(10, 5, density=0.5, format="csr"))


# --- the adjoint applies ---


def _dia(n=90, offsets=(-7, -1, 0, 2, 30), dtype=np.float64, seed=4):
	rng = np.random.default_rng(seed)
	bands = rng.standard_normal((len(offsets), n)).astype(dtype)
	if np.dtype(dtype).kind == "c":
		bands = bands + 1j * rng.standard_normal((len(offsets), n))
	op = DIAOperator.from_numpy(bands, offsets, (n, n), **CPU)
	return op, op.todense().numpy()


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.complex128])
@pytest.mark.parametrize("offsets", [(-7, -1, 0, 2, 30), (-95, 0, 90, 120)])
def test_dia_adjoint_applies(dtype, offsets):
	op, D = _dia(offsets=offsets, dtype=dtype)
	rng = np.random.default_rng(5)
	V = torch.from_numpy(rng.standard_normal((90, 6))).to(op.dtype)
	want = D.conj().T @ V.numpy()
	tol = 1e-5 if dtype == np.float32 else 1e-12
	for got in (op.rmatmat(V), op.rmatmat(V.T.contiguous().T), op.rmatmat_t(V.T.contiguous()).T, op.H.matmat(V),
		op.rmatmat_plain(V)):
		np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)
	np.testing.assert_allclose(op.rmatvec(V[:, 0]).numpy(), want[:, 0], rtol=tol, atol=tol)
	np.testing.assert_allclose(op.rmatmat_plain(V[:, 0]).numpy(), want[:, 0], rtol=tol, atol=tol)
	assert op._adjoint()[0] is op._adjoint()[0]  # built once


def test_dia_adjoint_carries_the_band_gradient():
	op, D = _dia()
	bands = op.bands.clone().requires_grad_(True)
	op2 = DIAOperator(bands, op.offsets, op.shape)
	V = torch.from_numpy(np.random.default_rng(6).standard_normal((90, 3)))
	(op2.rmatmat(V) ** 2).sum().backward()
	bands_ref = op.bands.clone().requires_grad_(True)
	(DIAOperator(bands_ref, op.offsets, op.shape).rmatmat_plain(V) ** 2).sum().backward()
	np.testing.assert_allclose(bands.grad.numpy(), bands_ref.grad.numpy(), rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.complex128])
@pytest.mark.parametrize("shape,bs", [((70, 45), (8, 16)), ((96, 96), (8, 8)), ((45, 70), (4, 4))])
def test_bsr_adjoint_applies(shape, bs, dtype):
	A = _rand_csr(*shape, 0.08, seed=7)
	if shape == (96, 96):  # empty block rows and columns
		A = A.tolil()
		A[16:40] = 0
		A[:, 40:56] = 0
		A = A.tocsr()
		A.eliminate_zeros()
	if np.dtype(dtype).kind == "c":
		A = (A + 1j * _rand_csr(*shape, 0.05, seed=8)).tocsr()
	op = BSROperator.from_scipy(A.astype(dtype), blocksize=bs, engine="scipy", **CPU)
	V = torch.from_numpy(np.random.default_rng(9).standard_normal((shape[0], 5))).to(op.dtype)
	want = A.toarray().conj().T @ V.numpy()
	tol = 1e-5 if dtype == np.float32 else 1e-12
	for got in (op.rmatmat(V), op.rmatmat(V.T.contiguous().T), op.rmatmat_t(V.T).T, op.rmatmat_plain(V)):
		np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)
	np.testing.assert_allclose(op.rmatvec(V[:, 0]).numpy(), want[:, 0], rtol=tol, atol=tol)


def test_rectangular_algebra_and_the_gram_operator():
	rng = np.random.default_rng(10)
	m, n, r = 72, 40, 3
	L, R = rng.standard_normal((m, r)), rng.standard_normal((n, r))
	G = _rand_csr(m, n, 0.1, seed=11)
	X = ptt.ComposedOperator(torch.from_numpy(L), torch.from_numpy(R.T.copy()), **CPU) + 0.5 * BSROperator.from_scipy(G, blocksize=(8, 8), **CPU)
	Xd = L @ R.T + 0.5 * G.toarray()
	assert X.shape == (m, n)
	V, U = torch.from_numpy(rng.standard_normal((n, 4))), torch.from_numpy(rng.standard_normal((m, 4)))
	np.testing.assert_allclose(X.matmat(V).numpy(), Xd @ V.numpy(), atol=1e-12)
	np.testing.assert_allclose(X.rmatmat(U).numpy(), Xd.T @ U.numpy(), atol=1e-12)
	np.testing.assert_allclose(X.rmatmat_t(U.T.contiguous()).numpy(), (Xd.T @ U.numpy()).T, atol=1e-12)
	np.testing.assert_allclose(X.matmat_t(V.T.contiguous()).numpy(), (Xd @ V.numpy()).T, atol=1e-12)
	np.testing.assert_allclose(X.T.matmat(U).numpy(), Xd.T @ U.numpy(), atol=1e-12)
	for tf, dense in ((True, Xd.T @ Xd), (False, Xd @ Xd.T)):
		gram = GramOperator(X, transpose_first=tf)
		W = torch.from_numpy(rng.standard_normal((gram.shape[0], 3)))
		np.testing.assert_allclose(gram.matmat(W).numpy(), dense @ W.numpy(), atol=1e-10)
		np.testing.assert_allclose(gram.matmat_t(W.T.contiguous()).numpy(), (dense @ W.numpy()).T, atol=1e-10)
	# The JAX package's Gram operator of the same dense matrix.
	from primate_tpu.operators.sparse import GramOperator as JaxGram

	W = rng.standard_normal((n, 3))
	np.testing.assert_allclose(GramOperator(torch.from_numpy(Xd)).matmat(torch.from_numpy(W)).numpy(),
		np.asarray(JaxGram(jnp.asarray(Xd)).matmat(jnp.asarray(W))), rtol=1e-12, atol=1e-12)
