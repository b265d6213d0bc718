"""The port's DIA stencil, fused Lanczos step and DIAOperator against the JAX package.

Inputs are made with numpy from a seed and handed to both packages. On the CPU
the port's wrappers run their plain PyTorch versions; the JAX side runs its
Pallas kernels in interpret mode, as the JAX package's own tests do.
"""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import jax.numpy as jnp

from primate_tpu.operators.sparse import DIAOperator as JaxDIA
from primate_tpu.ops.dia_pallas import HALO, LANE_TILE, dia_matmat, dia_matmat_t, dia_matmat_t_phys
from primate_tpu_torch import DIAOperator, dia_from_numpy
from primate_tpu_torch.operators import sparse
from primate_tpu_torch.operators.base import quad_form
from primate_tpu_torch.ops import _build
from primate_tpu_torch.ops.dia import dia_stencil, dia_stencil_ref, dia_stencil_t, lanczos_dia_step

torch.set_num_threads(1)


def _banded(n, offsets, seed, symmetric=False):
	rng = np.random.default_rng(seed)
	diags = [rng.normal(size=n - abs(o)) for o in offsets]
	A = sps.diags(diags, offsets, shape=(n, n)).tocsr()
	return (A + A.T).tocsr() if symmetric else A


def _pair(A):
	"""The same scipy matrix as a JAX and as a port DIAOperator."""
	return JaxDIA.from_scipy(A), DIAOperator.from_scipy(A, device="cpu")


def test_stencil_matches_jax_pallas_and_xla():
	# tests/test_dia.py:75-86's case: odd probe count, f64, atol 1e-10.
	jop, op = _pair(_banded(300, [-7, -1, 0, 1, 7], seed=7))
	Xt = np.random.default_rng(8).normal(size=(13, 300))
	got = op.matmat_t(torch.from_numpy(Xt)).numpy()
	assert got.shape == (13, 300)
	np.testing.assert_allclose(got, np.asarray(dia_matmat_t(jop, jnp.asarray(Xt), interpret=True)), rtol=0, atol=1e-10)
	np.testing.assert_allclose(got, np.asarray(jop.matmat_t(jnp.asarray(Xt))), rtol=0, atol=1e-10)


def test_stencil_wide_band_matches_jax_xla():
	# Bands wider than the TPU kernel's 128-lane halo: the port takes any offset.
	jop, op = _pair(_banded(600, [-200, -3, 0, 5, 200], seed=9))
	Xt = np.random.default_rng(12).normal(size=(4, 600))
	got = dia_stencil_t(op.bands, op.offsets_t, torch.from_numpy(Xt)).numpy()
	np.testing.assert_allclose(got, np.asarray(jop.matmat_t(jnp.asarray(Xt))), rtol=0, atol=1e-10)


@pytest.mark.parametrize("nv", [1, 13, 64])
def test_fem_pattern_probe_major_matches_jax(nv):
	"""The FEM cell's pattern at side 12 (n = 1,728; offsets ±1, ±12, ±144; float64):
	``matmat_t`` and the probe-major ``matmat`` against the JAX operator's ``matmat_t``,
	which takes its XLA stencil here, since ±144 is past the Pallas kernel's ``HALO``."""
	from benchmarks.matrices import fem_laplacian_3d

	A = fem_laplacian_3d(12).astype(np.float64)
	jop, op = _pair(A)
	assert sorted(op.offsets) == [-144, -12, -1, 0, 1, 12, 144] and max(op.offsets) > HALO
	Xt = np.random.default_rng(nv).normal(size=(nv, A.shape[0]))
	want = np.asarray(jop.matmat_t(jnp.asarray(Xt)))
	np.testing.assert_allclose(op.matmat_t(torch.from_numpy(Xt)).numpy(), want, rtol=0, atol=1e-10)
	np.testing.assert_allclose(op.matmat(torch.from_numpy(Xt).T).T.numpy(), want, rtol=0, atol=1e-10)
	np.testing.assert_allclose(want, (A @ Xt.T).T, rtol=0, atol=1e-10)


@pytest.mark.parametrize("dtype,atol", [(np.float32, 1e-5), (np.float64, 1e-10)])
def test_node_major_stencil_matches_jax_pallas(dtype, atol):
	"""dia_stencil vs the node-major Pallas kernel in interpret mode (k a multiple
	of 128, as tests/test_dia.py:31-38 runs it) and vs the XLA path."""
	A = _banded(300, [-7, -1, 0, 1, 7], seed=21).astype(dtype)
	jop, op = _pair(A)
	V = np.random.default_rng(22).normal(size=(300, 128)).astype(dtype)
	got = dia_stencil(op.bands, op.offsets_t, torch.from_numpy(V))
	assert got.dtype == torch.from_numpy(V).dtype and got.shape == (300, 128)
	np.testing.assert_allclose(got.numpy(), np.asarray(dia_matmat(jop, jnp.asarray(V), interpret=True)), rtol=0, atol=atol)
	np.testing.assert_allclose(got.numpy(), np.asarray(jop._matmat_jnp(jnp.asarray(V))), rtol=0, atol=atol)


def test_node_major_stencil_any_offset_and_width():
	# Offsets past n's middle and past the TPU's 2048-row halo, odd k, one column.
	A = _banded(3000, [-2500, -1, 0, 3, 2100], seed=23)
	jop, op = _pair(A)
	for k in (1, 5):
		V = np.random.default_rng(k).normal(size=(3000, k))
		got = dia_stencil_ref(op.bands, op.offsets_t, torch.from_numpy(V)).numpy()
		np.testing.assert_allclose(got, np.asarray(jop._matmat_jnp(jnp.asarray(V))), rtol=0, atol=1e-10)
		np.testing.assert_allclose(got, A @ V, rtol=0, atol=1e-10)


def test_matmat_picks_the_kernel_by_layout(monkeypatch):
	"""A probe-major block takes the probe-major stencil on its transpose, a
	node-major one the node-major stencil; neither is copied."""
	op = DIAOperator.from_scipy(_banded(50, [-3, 0, 2], seed=24), device="cpu")
	seen = []
	for name in ("dia_stencil_ad", "dia_stencil_t_ad"):  # the differentiable wrappers of the two kernels
		real = getattr(sparse, name)
		monkeypatch.setattr(sparse, name, lambda b, x, o, oh, _n=name, _f=real: (seen.append((_n, x.is_contiguous())), _f(b, x, o, oh))[1])
	Vt = torch.from_numpy(np.random.default_rng(25).normal(size=(4, 50)))
	probe_major, node_major = Vt.T, Vt.T.contiguous()
	np.testing.assert_array_equal(op.matmat(probe_major).numpy(), op.matmat(node_major).numpy())
	assert seen == [("dia_stencil_t_ad", True), ("dia_stencil_ad", True)]


@pytest.mark.parametrize("dtype,atol", [(np.float32, 1e-4), (np.float64, 1e-10)])
def test_fused_step_matches_jax_phys_kernel(dtype, atol):
	"""Fused step vs JAX's halo-padded stencil kernel (interpret mode) followed by
	the β-axpy and the α reduction in numpy."""
	rng = np.random.default_rng(0)
	n, nv, offsets = 3000, 8, (-100, -1, 0, 1, 100)
	bands = rng.normal(size=(len(offsets), n)).astype(dtype)
	unit = lambda X: (X / np.linalg.norm(X, axis=1, keepdims=True)).astype(dtype)  # noqa: E731 - Lanczos vectors
	q_cur, q_prev = unit(rng.normal(size=(nv, n))), unit(rng.normal(size=(nv, n)))
	beta = rng.uniform(0.5, 2.0, size=nv).astype(dtype)

	n_dom = -(-n // LANE_TILE) * LANE_TILE
	bands_dom = np.zeros((len(offsets), n_dom), dtype)
	bands_dom[:, :n] = bands
	Xp = np.zeros((nv, n_dom + 2 * HALO), dtype)
	Xp[:, HALO : HALO + n] = q_cur
	Aq = np.asarray(dia_matmat_t_phys(jnp.asarray(bands_dom), jnp.asarray(Xp), offsets, interpret=True))[:, HALO : HALO + n]
	v_want = Aq - beta[:, None] * q_prev
	alpha_want = np.sum(v_want * q_cur, axis=1)

	op = DIAOperator.from_numpy(bands, offsets, (n, n), device="cpu")
	v, alpha = lanczos_dia_step(op.bands, op.offsets_t, torch.from_numpy(q_cur), torch.from_numpy(q_prev), torch.from_numpy(beta))
	assert v.dtype == torch.from_numpy(q_cur).dtype and alpha.shape == (nv,)
	np.testing.assert_allclose(v.numpy(), v_want, rtol=0, atol=atol)
	np.testing.assert_allclose(alpha.numpy(), alpha_want, rtol=0, atol=atol)
	# The operator's hook is the same step.
	v2, alpha2 = op.lanczos_step(torch.from_numpy(q_cur), torch.from_numpy(q_prev), torch.from_numpy(beta))
	assert torch.equal(v, v2) and torch.equal(alpha, alpha2)


def test_operator_applies_match_jax():
	A = _banded(257, [-9, -2, 0, 1, 4], seed=3)  # non-symmetric, so rmatvec differs from matvec
	jop, op = _pair(A)
	rng = np.random.default_rng(4)
	V, v = rng.normal(size=(257, 6)), rng.normal(size=257)
	checks = [
		(op.matmat(torch.from_numpy(V)), jop.matmat(jnp.asarray(V))),
		(op.matvec(torch.from_numpy(v)), jop.matvec(jnp.asarray(v))),
		(op.rmatvec(torch.from_numpy(v)), jop.rmatvec(jnp.asarray(v))),
		(op.todense(), jop.todense()),
		(quad_form(op, torch.from_numpy(V)), (V * (A @ V)).sum(axis=0)),
	]
	for got, want in checks:
		np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-10)
	np.testing.assert_allclose(op.todense().numpy(), A.toarray(), rtol=0, atol=0)


def test_dia_from_numpy_of_a_jax_operator():
	jop = JaxDIA.from_scipy(_banded(120, [-5, 0, 2], seed=5))
	op = dia_from_numpy(np.asarray(jop.bands), jop.offsets, jop.shape, dtype=torch.float64, device="cpu")
	assert op.offsets == tuple(jop.offsets) and op.shape == tuple(jop.shape)
	np.testing.assert_array_equal(op.todense().numpy(), np.asarray(jop.todense()))


def test_wrappers_reject_tensors_off_cpu_and_cuda():
	"""Only CPU tensors take the plain version: any other device goes to the
	kernel path, which refuses what it cannot launch instead of falling back."""
	bands = torch.ones((3, 10), device="meta")
	offsets = torch.tensor([-1, 0, 1], device="meta")
	x = torch.empty((2, 10), device="meta")
	with pytest.raises(ValueError, match="CUDA"):
		dia_stencil_t(bands, offsets, x)
	with pytest.raises(ValueError, match="CUDA"):
		lanczos_dia_step(bands, offsets, x, x, torch.zeros(2, device="meta"))
	with pytest.raises(ValueError, match="bands"):
		dia_stencil_t(torch.ones((2, 10)), torch.tensor([0, 1]), torch.ones((2, 11)))


def test_build_raises_and_leaves_no_partial_library(tmp_path, monkeypatch):
	"""A failed nvcc run raises (no fallback) and leaves neither the library nor its temp file."""
	monkeypatch.setattr(_build, "_BUILD_DIR", tmp_path)
	monkeypatch.setattr(_build, "nvcc_path", lambda: "false")  # exits 1 like a failing compile
	with pytest.raises(RuntimeError, match="nvcc failed"):
		_build.build_library()
	assert list(tmp_path.iterdir()) == []
	assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
	# Each source builds its own library, named after the source's digest: an edited kernel rebuilds.
	real_sources = {_build._CSRC / "bsr_spmm.cu", _build._CSRC / "dia_stencil.cu"}
	assert set(_build._sources()) >= real_sources
	src = tmp_path / "csrc"
	src.mkdir()
	(src / "k.cu").write_text("// a\n")
	monkeypatch.setattr(_build, "_CSRC", src)
	before = _build._digest(src / "k.cu")
	(src / "k.cu").write_text("// b\n")
	assert _build._digest(src / "k.cu") != before
	# So does an edited shared header, which every source includes.
	for cu in real_sources:
		assert '#include "common.cuh"' in cu.read_text(), cu
	before = _build._digest(src / "k.cu")
	(src / "common.cuh").write_text("// c\n")
	assert _build._digest(src / "k.cu") != before
