"""The port's CSR and COO operators, aslinop and the operator algebra against the
JAX package, on the same scipy matrices and numpy blocks (f64).

The JAX ``CSROperator`` applies a power-law graph through its sliced-ELL planes
(more than one slot, and a hub tail beyond the slot cap) and a banded matrix
through full ELL planes; the port applies both by one library SpMM. Each test
asserts which layout the JAX object took, so the comparison covers it."""

import numpy as np
import pytest
import scipy.sparse as sps
import scipy.sparse.linalg as spsla
import torch

import jax.numpy as jnp

import primate_tpu as pt
from benchmarks.matrices import powerlaw_laplacian
from primate_tpu.lanczos import lanczos_block_op as jax_lanczos_block_op
from primate_tpu.operators.sparse import COOOperator as JaxCOO
from primate_tpu.operators.sparse import CSROperator as JaxCSR
from primate_tpu_torch import COOOperator, CSROperator, MatrixFunction, aslinop, coo_from_numpy, csr_from_numpy, hutch, lanczos_block_op
from primate_tpu_torch.operators.base import (
	AdjointOperator,
	AffineOperator,
	ComposedOperator,
	DenseOperator,
	FunctionOperator,
	ScaledOperator,
	is_linear_op,
	is_valid_operator,
	matmat,
)
from primate_tpu_torch.ops import _common

torch.set_num_threads(1)
TOL = 1e-12


def _powerlaw(n=2048):
	return powerlaw_laplacian(n=n, m=4, seed=0).astype(np.float64)


def _banded(n=1500):
	rng = np.random.default_rng(1)
	return sps.diags([rng.uniform(-1, 0, n - 3), -np.ones(n - 1), 6.0 + rng.uniform(size=n), -np.ones(n - 1), rng.uniform(-1, 0, n - 3)],
		[-3, -1, 0, 1, 3]).tocsr()


def _assert_jax_layout(jop, kind):
	if kind == "sliced":
		assert jop.ell_data is None and jop.sell is not None
		rank, s_data, s_idx, s_tail, n_hub = jop.sell
		assert len(s_data) > 1, "the JAX sliced-ELL path must cover more than one slot"
		assert s_tail is not None and n_hub > 0, "the power-law graph must overflow into the hub tail"
	else:
		assert jop.ell_data is not None and jop.sell is None


@pytest.mark.parametrize("kind", ["sliced", "ell"])
def test_csr_and_coo_applies_match_jax(kind):
	A = _powerlaw() if kind == "sliced" else _banded()
	n = A.shape[0]
	jcsr, jcoo = JaxCSR.from_scipy(A), JaxCOO.from_scipy(A)
	_assert_jax_layout(jcsr, kind)
	rng = np.random.default_rng(2)
	X, x = rng.normal(size=(n, 7)), rng.normal(size=n)
	for op, jop in ((CSROperator.from_scipy(A, device="cpu"), jcsr), (COOOperator.from_scipy(A, device="cpu"), jcoo)):
		assert op.nnz == A.nnz and op.shape == A.shape and op.dtype == torch.float64
		np.testing.assert_allclose(op.matmat(torch.from_numpy(X)).numpy(), np.asarray(jop.matmat(jnp.asarray(X))), rtol=0, atol=TOL)
		np.testing.assert_allclose(op.matvec(torch.from_numpy(x)).numpy(), np.asarray(jop.matvec(jnp.asarray(x))), rtol=0, atol=TOL)
		np.testing.assert_allclose(op.rmatvec(torch.from_numpy(x)).numpy(), np.asarray(jop.rmatvec(jnp.asarray(x))), rtol=0, atol=TOL)
		Xt = torch.from_numpy(np.ascontiguousarray(X.T))
		np.testing.assert_allclose(op.matmat_t(Xt).numpy(), np.asarray(jop.matmat(jnp.asarray(X))).T, rtol=0, atol=TOL)
		np.testing.assert_allclose(op.todense().numpy(), np.asarray(jop.todense()), rtol=0, atol=TOL)


def test_csr_probe_major_apply_and_layout_count():
	"""The SpMM reads a node-major block: a probe-major block (as the sampler draws it)
	is copied once, and ``matmat_t`` copies its result back to probe-major; both counted."""
	A = _powerlaw(1024)
	op = CSROperator.from_scipy(A, device="cpu")
	Vt = torch.from_numpy(np.random.default_rng(3).normal(size=(5, 1024)))
	_common.reset_launches()
	got = op.matmat_t(Vt)
	assert got.shape == (5, 1024) and got.is_contiguous()
	np.testing.assert_allclose(got.numpy(), (A @ Vt.numpy().T).T, rtol=0, atol=TOL)
	assert _common.LAYOUT_COPIES["csr_spmm"] == 2
	np.testing.assert_allclose(op.matmat(Vt.T).numpy(), A @ Vt.numpy().T, rtol=0, atol=TOL)
	assert _common.LAYOUT_COPIES["csr_spmm"] == 3
	op.matmat(Vt.T.contiguous())
	assert _common.LAYOUT_COPIES["csr_spmm"] == 3 and _common.LAUNCHES == dict.fromkeys(_common.LAUNCHES, 0)


def test_nonsymmetric_rmatvec_duplicates_and_constructors():
	rng = np.random.default_rng(4)
	A = sps.random(300, 300, density=0.03, random_state=rng, format="coo")
	# Repeated coordinates add up, in both formats and both packages.
	A = sps.coo_matrix((np.r_[A.data, [1.5, 2.5]], (np.r_[A.row, [7, 7]], np.r_[A.col, [9, 9]])), shape=A.shape)
	v = rng.normal(size=300)
	for op in (CSROperator.from_scipy(A, device="cpu"), COOOperator.from_scipy(A, device="cpu")):
		np.testing.assert_allclose(op.matvec(torch.from_numpy(v)).numpy(), A @ v, rtol=0, atol=TOL)
		np.testing.assert_allclose(op.rmatvec(torch.from_numpy(v)).numpy(), A.T @ v, rtol=0, atol=TOL)
	np.testing.assert_allclose(np.asarray(JaxCOO.from_scipy(A).rmatvec(jnp.asarray(v))), A.T @ v, rtol=0, atol=TOL)
	D = A.toarray()
	for op in (CSROperator.from_dense(D, device="cpu"), COOOperator.from_dense(D, device="cpu")):
		np.testing.assert_allclose(op.todense().numpy(), D, rtol=0, atol=TOL)
	C = A.tocsr()
	C.sum_duplicates()
	op = csr_from_numpy(C.data, C.indices, C.indptr, C.shape, device="cpu")
	np.testing.assert_allclose(op.todense().numpy(), D, rtol=0, atol=TOL)
	op = coo_from_numpy(A.data, A.row, A.col, A.shape, device="cpu", dtype=torch.float32)
	assert op.dtype == torch.float32
	with pytest.warns(UserWarning, match="not block-structured"):  # a scattered pattern fills its tiles
		bsr = CSROperator.from_scipy(C, device="cpu").tobsr(blocksize=(4, 4))
	np.testing.assert_allclose(bsr.todense().numpy(), D, rtol=0, atol=TOL)


def test_aslinop_of_scipy_inputs():
	A = _banded(400)
	X = np.random.default_rng(5).normal(size=(400, 3))
	for fmt in ("csr", "csc", "coo"):
		op = aslinop(A.asformat(fmt), device="cpu")
		assert isinstance(op, CSROperator) and op.device.type == "cpu"
		np.testing.assert_allclose(op.matmat(torch.from_numpy(X)).numpy(), A @ X, rtol=0, atol=TOL)
	assert aslinop(A, dtype=np.float32, device="cpu").dtype == torch.float32
	assert aslinop(A, dtype=torch.float32, device="cpu").dtype == torch.float32
	# A scipy LinearOperator computes on the host: its applies copy to the host and back.
	calls = []
	L = spsla.LinearOperator(A.shape, matvec=lambda v: A @ v, matmat=lambda V: calls.append(V.shape) or A @ V, dtype=np.float64)
	op = aslinop(L, device="cpu")
	assert isinstance(op, FunctionOperator) and not op.traceable and op.dtype == torch.float64
	np.testing.assert_allclose(op.matmat(torch.from_numpy(X)).numpy(), A @ X, rtol=0, atol=TOL)
	assert calls == [(400, 3)]
	np.testing.assert_allclose(np.asarray(pt.operators.aslinop(L).matmat(jnp.asarray(X))), A @ X, rtol=0, atol=TOL)
	assert is_valid_operator(A) == torch.float64 and is_valid_operator(L) == torch.float64
	assert is_valid_operator(A.astype(np.float32)) == torch.float32
	assert is_linear_op(A) and is_linear_op(op) and not is_linear_op(np.zeros((3, 4)))


def test_aslinop_of_protocol_objects():
	M = torch.from_numpy(np.random.default_rng(6).normal(size=(30, 30)))
	X = torch.from_numpy(np.random.default_rng(7).normal(size=(30, 4)))

	class Matmat:
		shape, dtype = (30, 30), torch.float64

		def matmat(self, V):
			return M @ V

	class Matvec:
		shape, dtype = (30, 30), np.float64

		def matvec(self, v):
			return M @ v

	for obj in (Matmat(), Matvec()):
		op = aslinop(obj, device="cpu")
		assert isinstance(op, FunctionOperator) and op.dtype == torch.float64
		torch.testing.assert_close(op.matmat(X), M @ X, rtol=0, atol=TOL)
	f = FunctionOperator(lambda W, V: W @ V, (30, 30), dtype=torch.float64, captures=(M,), device="cpu")
	torch.testing.assert_close(f.matmat(X), M @ X, rtol=0, atol=TOL)
	torch.testing.assert_close(matmat(M.numpy(), X), M @ X, rtol=0, atol=TOL)
	with pytest.raises(TypeError):
		aslinop(object())


def test_operator_algebra_matches_numpy_and_jax():
	rng = np.random.default_rng(8)
	A = _banded(200)
	B = rng.normal(size=(200, 200))
	Ad = A.toarray()
	X = rng.normal(size=(200, 5))
	a, b = CSROperator.from_scipy(A, device="cpu"), DenseOperator(torch.from_numpy(B))
	ja, jb = JaxCSR.from_scipy(A), pt.operators.aslinop(B)
	cases = [
		(a + b, Ad + B, ja + jb, AffineOperator),
		(a - b, Ad - B, ja - jb, AffineOperator),
		(a + 1.5, Ad + 1.5 * np.eye(200), ja + 1.5, AffineOperator),
		(a - 0.5, Ad - 0.5 * np.eye(200), ja - 0.5, AffineOperator),
		(3.0 - a, 3.0 * np.eye(200) - Ad, 3.0 - ja, ScaledOperator),
		(2.0 * a, 2.0 * Ad, 2.0 * ja, ScaledOperator),
		(a * 2.0, 2.0 * Ad, ja * 2.0, ScaledOperator),
		(a / 4.0, Ad / 4.0, ja / 4.0, ScaledOperator),
		(-a, -Ad, -ja, ScaledOperator),
		(a @ b, Ad @ B, ja @ jb, ComposedOperator),
		(b.T, B.T, jb.T, AdjointOperator),
		(b.H, B.T, jb.H, AdjointOperator),
		((a @ b).T, (Ad @ B).T, (ja @ jb).T, AdjointOperator),
		(np.eye(200) + a, np.eye(200) + Ad, np.eye(200) + ja, AffineOperator),
	]
	for op, want, jop, kind in cases:
		assert isinstance(op, kind), (type(op), kind)
		got = op.matmat(torch.from_numpy(X)).numpy()
		np.testing.assert_allclose(got, want @ X, rtol=0, atol=1e-10)
		np.testing.assert_allclose(got, np.asarray(jop.matmat(jnp.asarray(X))), rtol=0, atol=1e-10)
	assert (b.T).T is b and (b.H).H is b
	np.testing.assert_allclose(AffineOperator(a, b, 0.5).set_parameter(2.0).matmat(torch.from_numpy(X)).numpy(), (Ad + 2 * B) @ X, atol=1e-10)
	np.testing.assert_allclose((a + b).matmat_t(torch.from_numpy(np.ascontiguousarray(X.T))).numpy(), ((Ad + B) @ X).T, atol=1e-10)


@pytest.mark.parametrize("orth,deg", [(5, 20), (20, 20), (0, 12)])
def test_slq_alpha_beta_through_csr_match_jax(orth, deg):
	"""The Lanczos coefficients of BASELINE config 2's sweep (orth 5) on a power-law
	graph through the port's CSR operator and through the JAX sliced-ELL apply, to
	1e-10 of the spectrum's scale. The two applies sum each row in another order
	(1e-13 apart); once the hubs' isolated Ritz values converge, a sweep without a
	full window amplifies that (orth 5: 5e-10 at step 20; orth 0: 5e-4), so the
	sweep without re-orthogonalisation is held over its first 12 steps."""
	A = _powerlaw()
	V0 = np.random.default_rng(9).choice([-1.0, 1.0], size=(A.shape[0], 16))
	got = lanczos_block_op(CSROperator.from_scipy(A, device="cpu"), torch.from_numpy(V0), deg=deg, ncv=max(orth, 2), orth=orth, return_basis=False)
	jop = JaxCSR.from_scipy(A)
	_assert_jax_layout(jop, "sliced")
	want = jax_lanczos_block_op(jop, jnp.asarray(V0), deg=deg, ncv=max(orth, 2), orth=orth, return_basis=False)
	scale = float(np.abs(np.asarray(want.alphas)).max())
	np.testing.assert_allclose(got.alphas.numpy(), np.asarray(want.alphas), rtol=0, atol=1e-10 * scale)
	np.testing.assert_allclose(got.betas.numpy(), np.asarray(want.betas), rtol=0, atol=1e-10 * scale)


def test_hutch_of_a_scipy_laplacian_matches_jax():
	"""``hutch(MatrixFunction(L_scipy, "log"))``: the scipy matrix handed straight in,
	the probes from one numpy sampler per package built from the same seed."""
	A = _powerlaw(1500)

	def sampler(seed):
		rng = np.random.default_rng(seed)
		return lambda size: rng.choice([-1.0, 1.0], size=size)

	kw = dict(batch=8, converge="count", count=24)
	M = MatrixFunction(A, "log", deg=20, orth=5, device="cpu")
	assert isinstance(M.operator, CSROperator)
	got = hutch(M, pdf=sampler(3), **kw)
	want = pt.hutch(pt.MatrixFunction(A, "log", deg=20, orth=5), pdf=sampler(3), **kw)
	np.testing.assert_allclose(got, want, rtol=1e-10, atol=0)
	logdet = np.sum(np.log(np.linalg.eigvalsh(A.toarray())))
	assert 0 <= got and abs(got - logdet) / logdet < 0.05
