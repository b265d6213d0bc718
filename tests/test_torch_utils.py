"""The port's utilities against the JAX package's: kwargs routing, checkpoints (JSON structure,
no pickle), the counting operator, the kernel cost model and the matvec benchmark."""

import zipfile

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import jax.numpy as jnp

import primate_tpu as pt
import primate_tpu_torch as ptt
from primate_tpu.operators.sparse import BSROperator as JaxBSR
from primate_tpu.operators.sparse import CSROperator as JaxCSR
from primate_tpu.operators.sparse import DIAOperator as JaxDIA
from primate_tpu.utils import kwargs as jkwargs
from primate_tpu.utils.profiling import kernel_stats as jax_kernel_stats
from primate_tpu_torch.stats import CovState, cov_update, make_cov_state
from primate_tpu_torch.utils import kwargs as tkwargs
from primate_tpu_torch.utils.checkpoint import EstimatorCheckpoint, load_pytree, save_pytree
from primate_tpu_torch.utils.profiling import CountingOperator, annotate, benchmark_matvec, kernel_stats

torch.set_num_threads(1)


def _f(a, b=1, *, c=2):
	return a + b + c


def _posonly(x, /, y=1):
	return x + y


def _varkw(a, **rest):
	return a


class _Unhashable:
	__hash__ = None

	def __call__(self, a, d=0):
		return a


@pytest.mark.parametrize("fun", [_f, _posonly, _varkw, _Unhashable(), len], ids=["kw", "posonly", "varkw", "unhashable", "builtin"])
def test_kwargs_routing_matches_jax(fun):
	kw = {"a": 1, "b": 2, "c": 3, "d": 4, "x": 5, "y": 6}
	for name in ("split_kwargs", "restrict_kwargs", "setdiff_kwargs"):
		assert getattr(tkwargs, name)(fun, kw) == getattr(jkwargs, name)(fun, kw)
		assert getattr(tkwargs, name)(fun, {}) == getattr(jkwargs, name)(fun, {})
	assert ptt.utils.restrict_kwargs is tkwargs.restrict_kwargs


def test_checkpoint_round_trip_without_pickle(tmp_path):
	st = cov_update(make_cov_state(2, torch.float64, "cpu"), torch.arange(6.0, dtype=torch.float64).reshape(3, 2))
	tree = {"a": torch.arange(5.0), "b": (np.ones((2, 3)), 7, 2.5, None, "tag"), "nested": [{"x": torch.eye(2)}], "cov": st}
	save_pytree(tmp_path / "state", tree)
	path = tmp_path / "state.npz"
	with zipfile.ZipFile(path) as z:
		assert all(name.endswith(".npy") for name in z.namelist())
	with np.load(path, allow_pickle=False) as data:  # every entry is a plain array
		assert "__structure__" in data.files and all(data[k].dtype != object for k in data.files)
	back = load_pytree(tmp_path / "state", device="cpu")
	assert torch.equal(back["a"], tree["a"]) and back["a"].dtype == torch.float32
	assert isinstance(back["b"], tuple) and torch.equal(back["b"][0], torch.ones((2, 3), dtype=torch.float64))
	assert back["b"][1:] == (7, 2.5, None, "tag")
	assert torch.equal(back["nested"][0]["x"], torch.eye(2))
	cov = back["cov"]
	assert isinstance(cov, CovState) and cov.n == 3 and torch.equal(cov.S, st.S) and torch.equal(cov.mu, st.mu)
	# A resumed state keeps streaming.
	more = cov_update(cov, torch.ones((2, 2), dtype=torch.float64))
	assert more.n == 5


def test_foreign_namedtuples_come_back_by_name(tmp_path):
	from collections import namedtuple

	Pair = namedtuple("Pair", ["left", "right"])
	save_pytree(tmp_path / "p.npz", Pair(torch.zeros(2), 3))
	back = load_pytree(tmp_path / "p.npz", device="cpu")
	assert type(back).__name__ == "Pair" and back._fields == ("left", "right") and back.right == 3


def test_estimator_checkpoint_via_hutch_callback(tmp_path):
	A = torch.from_numpy(np.array(pt.symmetric(32, pd=True, seed=0), np.float64))
	ckpt = EstimatorCheckpoint(tmp_path / "run.npz", every=2, device="cpu")
	assert ckpt.load() is None
	est, res = ptt.hutch(A, callback=ckpt, converge="count", count=64, batch=8, seed=1, full=True)
	state = ckpt.load()
	assert int(state["nit"]) == 64 and float(state["estimate"]) == est
	assert int(state["state"]["n"]) == 64
	assert torch.allclose(state["state"]["mean"], res.estimator.state.mu, rtol=0, atol=0)
	assert np.isclose(float(state["state"]["var"]), res.estimator.converged_variance, rtol=1e-12)


def test_counting_operator():
	A = torch.from_numpy(np.array(pt.symmetric(16, seed=1), np.float64))
	op = CountingOperator(A)
	V = torch.from_numpy(np.random.default_rng(0).normal(size=(16, 4)))
	assert torch.equal(op.matmat(V), A @ V) and op.n_matvecs == 4 and op.matvec_time > 0
	with annotate("test-region"):
		op.matvec(V[:, 0])
	assert op.n_matvecs == 5
	op.matmat_t(V.T.contiguous())
	op.rmatmat(V[:, :2])
	assert op.n_matvecs == 11
	# Through an estimator: one column per probe.
	ptt.hutch(op, converge="count", count=24, batch=8, seed=2)
	assert op.n_matvecs == 35


def _operators():
	n = 96
	L = sps.diags([-np.ones(n - 1), 3 * np.ones(n), -np.ones(n - 1)], [-1, 0, 1]).tocsr()
	S = sps.random(n, n, density=0.1, random_state=3, format="csr")
	S = (S + S.T + sps.eye(n)).tocsr()
	D = np.array(pt.symmetric(n, seed=4), np.float64)
	return [
		("dense", ptt.DenseOperator(torch.from_numpy(D)), jnp.asarray(D)),
		("dia", ptt.DIAOperator.from_scipy(L.todia(), device="cpu"), JaxDIA.from_scipy(L.todia())),
		("csr", ptt.CSROperator.from_scipy(S, device="cpu"), JaxCSR.from_scipy(S)),
		("bsr", ptt.BSROperator.from_scipy(S, blocksize=(8, 8), device="cpu"), JaxBSR.from_scipy(S, blocksize=(8, 8))),
	]


@pytest.mark.parametrize("case", range(4), ids=["dense", "dia", "csr", "bsr"])
def test_kernel_stats_match_jax(case):
	_, op, jop = _operators()[case]
	assert kernel_stats(op) == jax_kernel_stats(jop)


def test_benchmark_matvec_keys():
	_, op, _ = _operators()[1]
	res = benchmark_matvec(op, k=8, iters=4, warmup=1)
	assert set(res) == {"sec_per_matmat", "matvecs_per_s", "nnz_per_s", "effective_GBps"}
	assert all(v > 0 for v in res.values())
	assert set(benchmark_matvec(ptt.FunctionOperator(lambda V: V, (8, 8), dtype=torch.float64, device="cpu"), k=2, iters=2)) == {
		"sec_per_matmat", "matvecs_per_s"}
