"""The port's sketch estimators and their dense algebra against the JAX package.

The two packages draw different random numbers from the same seed, so these
tests regenerate the JAX package's probes exactly as its programs draw them
(``split``/``fold_in`` of ``as_key(seed)``) and hand them to the port's cores.
Operators: a banded SPD matrix as DIA and a block SPD matrix as BSR (8x8 tiles),
float64. Tolerance: relative 1e-8 on every estimate, where the two sides differ
only in the order of float64 sums and in the LAPACK calls behind QR/Cholesky.
"""

import warnings

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import jax
import jax.numpy as jnp

import primate_tpu as pt
from primate_tpu import linalg as jlin
from primate_tpu.operators.sparse import BSROperator as JaxBSR
from primate_tpu.operators.sparse import DIAOperator as JaxDIA
from primate_tpu.random import as_key
from primate_tpu.random import sample_isotropic as jax_sample
from benchmarks.matrices import block_random_spd, fem_laplacian_3d

from primate_tpu_torch import BSROperator, DeflatedOperator, DIAOperator, diag, diagpp, hutch, hutchpp, xdiag, xnystrace, xtrace
from primate_tpu_torch import linalg
from primate_tpu_torch.diagonal import diagpp_core, run_diag, xdiag_core
from primate_tpu_torch.estimators import CountCriterion, ToleranceCriterion
from primate_tpu_torch.trace import hutchpp_core, hutchpp_sketch, run_xtrace, xnystrace_core

torch.set_num_threads(1)
RTOL = 1e-8
SEED = 3


def _banded_spd(n=120):
	rng = np.random.default_rng(0)
	offs = (-10, -1, 1, 10)
	diags = [rng.uniform(-1, 1, n - abs(o)) for o in offs]
	A = sps.diags(diags, offs, shape=(n, n))
	A = (A + A.T) * 0.5
	return (A + sps.diags(np.abs(A).sum(axis=1).A.ravel() + 0.5)).tocsr()


def _operators(kind):
	"""(JAX operator, port operator, dense matrix) of one SPD matrix."""
	if kind == "dia":
		A = _banded_spd()
		return JaxDIA.from_scipy(A), DIAOperator.from_scipy(A, device="cpu"), A.toarray()
	A = block_random_spd(n=96, bs=8, density=0.1, seed=5).astype(np.float64)
	return JaxBSR.from_scipy(A, blocksize=(8, 8)), BSROperator.from_scipy(A, blocksize=(8, 8), device="cpu"), A.toarray()


def _probes(key, shape, pdf):
	return torch.from_numpy(np.array(jax_sample(key, shape, pdf=pdf, dtype=jnp.float64)))


def _fold_in_stream(seed, n, pdf):
	"""The JAX package's round-``it`` probe block ``fold_in(as_key(seed), it)``, as ``draw(it, k)``."""
	key = as_key(seed)
	return lambda it, k: _probes(jax.random.fold_in(key, it), (n, k), pdf)


def _close(got, want, rtol=RTOL):
	np.testing.assert_allclose(np.asarray(got, dtype=float), np.asarray(want, dtype=float), rtol=rtol, atol=0)


def _spectrum_matrix(n, seed=1234):
	rng = np.random.default_rng(seed)
	ew = rng.uniform(1 / n, 1.0, n)
	U, _ = np.linalg.qr(rng.normal(size=(n, n)))
	return (U * ew) @ U.T, float(ew.sum())


# --- dense algebra -----------------------------------------------------------


def _tall(n, m, rank=None, seed=0):
	rng = np.random.default_rng(seed)
	if rank is None:
		return rng.normal(size=(n, m))
	return rng.normal(size=(n, rank)) @ rng.normal(size=(rank, m))


@pytest.mark.parametrize("shape", [(400, 12), (30, 10)], ids=["cholqr3", "householder"])
def test_tall_qr_matches_jax(shape):
	Y = _tall(*shape)
	Q, R = linalg.tall_qr(torch.from_numpy(Y))
	Qj, Rj = jlin.tall_qr(jnp.asarray(Y))
	np.testing.assert_allclose(Q.numpy(), np.asarray(Qj), rtol=0, atol=1e-10)
	np.testing.assert_allclose(R.numpy(), np.asarray(Rj), rtol=0, atol=1e-10)
	if shape[0] >= 8 * shape[1]:
		assert Q.is_contiguous()  # node-major: the sparse kernels read it without a copy


def test_tall_qr_rank_deficient_falls_back_to_householder():
	Y = _tall(400, 12, rank=6)
	Q, R = linalg.tall_qr(torch.from_numpy(Y))
	assert torch.isfinite(Q).all() and torch.isfinite(R).all()
	np.testing.assert_allclose((Q @ R).numpy(), Y, rtol=0, atol=1e-10)
	np.testing.assert_allclose((Q.T @ Q).numpy(), np.eye(12), rtol=0, atol=1e-10)
	Qj, Rj = jlin.tall_qr(jnp.asarray(Y))
	np.testing.assert_allclose((Q @ R).numpy(), np.asarray(Qj @ Rj), rtol=0, atol=1e-10)


def test_qr_append_and_trinv_updates_match_jax():
	Y1, Y2 = _tall(300, 8, seed=1), _tall(300, 5, seed=2)
	Q, R = linalg.qr_append(None, None, torch.from_numpy(Y1))
	Q, R = linalg.qr_append(Q, R, torch.from_numpy(Y2))
	Qj, Rj = jlin.qr_append(None, None, jnp.asarray(Y1))
	Qj, Rj = jlin.qr_append(Qj, Rj, jnp.asarray(Y2))
	np.testing.assert_allclose(Q.numpy(), np.asarray(Qj), rtol=0, atol=1e-10)
	np.testing.assert_allclose(R.numpy(), np.asarray(Rj), rtol=0, atol=1e-10)
	R1_inv = torch.linalg.inv(R[:8, :8])
	got = linalg.update_trinv_block(R1_inv, R[:8, 8:], R[8:, 8:])
	want = jlin.update_trinv_block(jnp.asarray(R1_inv.numpy()), jnp.asarray(R[:8, 8:].numpy()), jnp.asarray(R[8:, 8:].numpy()))
	np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-10)
	np.testing.assert_allclose((got @ R).numpy(), np.eye(13), rtol=0, atol=1e-10)
	one = linalg.update_trinv(R1_inv[:7, :7], R[:8, 7])
	np.testing.assert_allclose(one.numpy(), np.asarray(jlin.update_trinv(jnp.asarray(R1_inv[:7, :7].numpy()), jnp.asarray(R[:8, 7].numpy()))), atol=1e-10)
	X = torch.from_numpy(Y1)
	np.testing.assert_allclose(linalg.colwise_dot(X, 2 * X).numpy(), np.asarray(jlin.colwise_dot(jnp.asarray(Y1), 2 * jnp.asarray(Y1))))


def test_full_f32_guard_restores_the_callers_setting():
	before = torch.backends.cuda.matmul.allow_tf32
	torch.backends.cuda.matmul.allow_tf32 = True
	try:
		with linalg.full_f32_matmul():
			assert not torch.backends.cuda.matmul.allow_tf32
		assert torch.backends.cuda.matmul.allow_tf32
	finally:
		torch.backends.cuda.matmul.allow_tf32 = before


# --- trace estimators on injected JAX probes -----------------------------------


@pytest.mark.parametrize("mode", ["reduced", "full"])
@pytest.mark.parametrize("kind", ["dia", "bsr"])
def test_hutchpp_matches_jax(kind, mode):
	jop, op, _ = _operators(kind)
	n, nb = op.shape[0], 12
	k1, k2 = jax.random.split(as_key(SEED))
	est, rng_ests, defl_ests = hutchpp_core(op, _probes(k1, (n, nb), "rademacher"), _probes(k2, (n, nb), "rademacher"), mode)
	want, res = pt.hutchpp(jop, m=nb, seed=SEED, mode=mode, full=True)
	_close(float(est), want)
	_close(torch.cat([rng_ests, defl_ests]).numpy(), res.samples)


def test_adaptive_hutchpp_matches_jax():
	jop, op, _ = _operators("bsr")
	n, nb, batch = op.shape[0], 12, 8
	k1, k2 = jax.random.split(as_key(SEED))
	Q, sketch = hutchpp_sketch(op, _probes(k1, (n, nb), "rademacher"))
	stream = _fold_in_stream(k2, n, "rademacher")
	calls = []

	def pdf(generator, shape, dtype):  # the JAX hutch's batch `it` draws fold_in(k2, it)
		calls.append(shape)
		return stream(len(calls) - 1, shape[1])

	rest = hutch(DeflatedOperator(op, Q), batch=batch, pdf=pdf, converge="count", count=24)
	want, res = pt.hutchpp(jop, m=nb, batch=batch, converge="count", count=24, seed=SEED, full=True)
	assert len(calls) == 3
	_close(sketch, res.info["sketch_trace"])
	_close(sketch + rest, want)
	got, gres = hutchpp(op, m=nb, batch=batch, converge="count", count=24, seed=SEED, full=True)
	assert gres.nit == res.nit == 24 + 2 * nb and gres.info["sketch_rank"] == nb and np.isfinite(got)


@pytest.mark.parametrize("kind", ["dia", "bsr"])
def test_xtrace_count_path_matches_jax(kind):
	jop, op, _ = _operators(kind)
	n = op.shape[0]
	got, res = run_xtrace(op, _fold_in_stream(SEED, n, "sphere"), 16, True, CountCriterion(n) | CountCriterion(48), full=True)
	want, jres = pt.xtrace(jop, batch=16, converge="count", count=48, seed=SEED, full=True)
	assert res.nit == jres.nit == 48 and res.info["state"]["it"] == 3
	_close(got, want)
	for k in ("W", "Z", "Q", "R", "R_inv"):
		np.testing.assert_allclose(res.info["state"][k].numpy(), np.asarray(jres.info["state"][k]), rtol=0, atol=1e-8)


def test_xtrace_adaptive_path_matches_jax():
	jop, op, _ = _operators("dia")
	n = op.shape[0]
	crit = CountCriterion(n) | ToleranceCriterion(rtol=2e-3)
	got, res = run_xtrace(op, _fold_in_stream(SEED, n, "sphere"), 16, True, crit, full=True)
	want, jres = pt.xtrace(jop, batch=16, converge="tolerance", rtol=2e-3, seed=SEED, full=True)
	assert res.nit == jres.nit and 16 <= res.nit < n
	_close(got, want)
	assert np.isfinite(float(res.estimator.delta[0]))  # round-over-round move, not estimate − 0


def test_xtrace_resume_is_bit_exact():
	_, op, _ = _operators("bsr")
	fresh, fres = xtrace(op, batch=16, converge="count", count=64, seed=9, full=True)
	_, half = xtrace(op, batch=16, converge="count", count=32, seed=9, full=True)
	resumed, rres = xtrace(op, batch=16, converge="count", count=64, seed=9, full=True, resume=half)
	assert half.nit == 32 and rres.nit == fres.nit == 64 and rres.info["state"]["it"] == 4
	assert resumed == fresh
	for k in ("W", "Z", "Q", "R", "R_inv"):
		assert torch.equal(rres.info["state"][k], fres.info["state"][k])
	# A resume at m = n has no round left: the estimates are recomputed once from the state.
	whole, wres = xtrace(op, batch=32, seed=9, full=True)
	assert wres.nit == op.shape[0]
	assert xtrace(op, batch=32, seed=9, converge="tolerance", rtol=1e-12, resume=wres) == whole


@pytest.mark.parametrize("kind", ["dia", "bsr"])
def test_xnystrace_matches_jax(kind):
	jop, op, _ = _operators(kind)
	n, m = op.shape[0], 30
	t = xnystrace_core(op, _probes(as_key(SEED), (n, m), "normal"))
	want, jres = pt.xnystrace(jop, m=m, seed=SEED, full=True)
	_close(t.numpy(), jres.samples)
	_close(float(t.mean()), want)
	got, res = xnystrace(op, m=m, seed=SEED, full=True)
	assert res.nit == m and abs(got - want) / want < 0.05


# --- diagonal estimators on injected JAX probes --------------------------------


@pytest.mark.parametrize("kind", ["dia", "bsr"])
def test_xdiag_matches_jax(kind):
	jop, op, _ = _operators(kind)
	n = op.shape[0]
	got = xdiag_core(op, _probes(as_key(SEED), (n, 20), "sphere"))
	_close(got.numpy(), pt.xdiag(jop, m=40, seed=SEED))


@pytest.mark.parametrize("kind", ["dia", "bsr"])
def test_diagpp_matches_jax(kind):
	jop, op, _ = _operators(kind)
	n, nb = op.shape[0], 16
	k1, k2 = jax.random.split(as_key(SEED))
	got = diagpp_core(op, _probes(k1, (n, nb), "rademacher"), _probes(k2, (n, nb), "rademacher"))
	_close(got.numpy(), pt.diagpp(jop, m=nb, seed=SEED))


@pytest.mark.parametrize("batch", [1, 4])
@pytest.mark.parametrize("kind", ["dia", "bsr"])
def test_diag_count_path_matches_jax(kind, batch):
	jop, op, _ = _operators(kind)
	n = op.shape[0]
	stream = _fold_in_stream(SEED, n, "rademacher")
	got, res = run_diag(op, lambda it: stream(it, batch), CountCriterion(12), batch=batch, full=True)
	want, jres = pt.diag(jop, converge="count", count=12, seed=SEED, batch=batch, full=True)
	assert res.nit == jres.nit == 12
	_close(got, want)
	_close(res.info["state"]["m2"].numpy(), jres.info["state"]["m2"], rtol=1e-7)


def test_diag_on_the_fem_pattern_matches_jax(monkeypatch):
	"""``diag`` on the FEM cell's pattern at side 12 (n = 1,728; offsets ±1, ±12, ±144;
	float64), the JAX package's probes handed in probe-major as the port draws them:
	every batch goes through the probe-major stencil, and the estimate meets JAX ``diag``."""
	from primate_tpu_torch.ops import autograd  # the operator applies reach the kernel wrappers through it

	A = fem_laplacian_3d(12).astype(np.float64)
	jop, op = JaxDIA.from_scipy(A), DIAOperator.from_scipy(A, device="cpu")
	n, batch, count = A.shape[0], 16, 8
	calls = []
	real = autograd.dia_stencil_t
	monkeypatch.setattr(autograd, "dia_stencil_t", lambda b, o, x: (calls.append(x.shape), real(b, o, x))[1])
	stream = _fold_in_stream(SEED, n, "rademacher")
	got, res = run_diag(op, lambda it: stream(it, batch).T.contiguous().T, CountCriterion(count), batch=batch, full=True)
	want, jres = pt.diag(jop, converge="count", count=count, seed=SEED, batch=batch, full=True)
	assert res.nit == jres.nit == count and calls == [(batch, n)] * count
	_close(got, want)


def test_diag_adaptive_path_matches_jax():
	jop, op, _ = _operators("dia")
	n = op.shape[0]
	stream = _fold_in_stream(SEED, n, "rademacher")
	got, res = run_diag(op, lambda it: stream(it, 8), ToleranceCriterion(rtol=0.02), batch=8, full=True)
	want, jres = pt.diag(jop, converge="tolerance", rtol=0.02, seed=SEED, batch=8, full=True)
	assert res.nit == jres.nit and 1 < res.nit < 4096
	_close(got, want)


# --- the JAX tests' exactness bars, on the port alone -------------------------


def test_xtrace_exact_at_full_rank_on_bsr():
	"""tests/test_trace.py:80-96: XTrace at m = n with sphere probes is exact to rounding."""
	A, tr = _spectrum_matrix(40)
	op = BSROperator.from_dense(A, blocksize=(8, 8), device="cpu")
	assert abs(xtrace(op, seed=np.random.default_rng(1234)) - tr) <= 1e-6
	assert abs(xtrace(op, batch=7, seed=5) - tr) <= 1e-6


def test_hutchpp_at_full_rank_and_exact_sketches_on_dia():
	"""tests/test_trace.py:49-57: Hutch++ at m = n within 1/sqrt(n) of the trace."""
	A, tr = _spectrum_matrix(54)
	op = BSROperator.from_dense(A, blocksize=(8, 8), device="cpu")
	assert abs(hutchpp(op, m=54, seed=1) - tr) <= 1 / np.sqrt(54)
	assert abs(hutchpp(op, m=54, seed=1, mode="full") - hutchpp(op, m=54, seed=1)) <= 1e-8
	# Exact on a diagonal (rank-n DIA) operator once the sketch spans everything.
	d = np.linspace(1.0, 2.0, 30)
	dop = DIAOperator.from_scipy(sps.diags(d).tocsr(), device="cpu")
	np.testing.assert_allclose(diagpp(dop, m=30, seed=2), d, rtol=1e-8)
	low = DIAOperator.from_scipy(sps.diags(np.r_[d[:10], np.zeros(20)]).tocsr(), device="cpu")  # rank 10 < m: XNysTrace is exact
	assert abs(xnystrace(low, m=12, seed=2) - d[:10].sum()) <= 1e-8 * d[:10].sum()
	with warnings.catch_warnings():
		warnings.simplefilter("error")
		assert np.allclose(diag(dop, converge="count", count=3, batch=2, seed=1), d)
