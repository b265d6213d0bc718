"""The port's streaming statistics (``Mean``, ``Covariance``, ``mean_update``, ``confidence_interval``)
against the JAX package's on the same samples, float64, at 1e-12."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import primate_tpu.stats as jstats
import primate_tpu_torch.stats as stats
from primate_tpu_torch.convert import mean_state_from_numpy

torch.set_num_threads(1)
TOL = 1e-12


def _close(got, want, tol=TOL):
	got = got.cpu().numpy() if isinstance(got, torch.Tensor) else got
	np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol)


def test_all_matches_jax():
	assert set(stats.__all__) == set(jstats.__all__)
	assert stats.ConfidenceEstimator is __import__("primate_tpu_torch").ConfidenceEstimator


@pytest.mark.parametrize("dim", [1, 3])
def test_mean_and_covariance_stream_as_jax_does(dim):
	X = np.random.default_rng(1234).normal(size=(90, dim))
	m, jm = stats.Mean(dim, dtype=torch.float64, device="cpu"), jstats.Mean(dim, dtype=jnp.float64)
	c, jc = stats.Covariance(dim, dtype=torch.float64, device="cpu"), jstats.Covariance(dim, dtype=jnp.float64)
	assert np.isnan(m.mean()) and np.isnan(c.mean()) and np.isinf(np.asarray(c(ddof=1))).all()
	for chunk in np.array_split(X if dim > 1 else X[:, 0], 9):
		for est, jest in ((m, jm), (c, jc)):
			est.update(chunk)
			jest.update(chunk)
			assert est.n == jest.n
			_close(est.mean(), jest.mean())
		_close(c(ddof=1), jc(ddof=1))
		_close(c.covariance(ddof=0), jc.covariance(ddof=0))
		_close(c.S, jc.S)
	ref = np.cov(X.T, ddof=1)
	_close(c(), ref if dim > 1 else float(ref), 1e-10)
	assert isinstance(m.mean(), float if dim == 1 else torch.Tensor)


def test_mean_update_and_mean_state_from_numpy():
	X = np.random.default_rng(5).normal(size=(40, 3))
	st, jst = stats.make_mean_state(3, torch.float64, "cpu"), jstats.make_mean_state(3, jnp.float64)
	for i in range(0, 40, 8):
		st = stats.mean_update(st, torch.from_numpy(X[i : i + 8]))
		jst = jstats.mean_update(jst, jnp.asarray(X[i : i + 8]))
		assert st.n == int(jst.n)
		_close(st.mu, jst.mu)
	_close(st.mu, X.mean(axis=0))
	# A JAX Welford state carried across continues in the port.
	half = jstats.mean_update(jstats.make_mean_state(3, jnp.float64), jnp.asarray(X[:16]))
	carried = mean_state_from_numpy(int(half.n), np.asarray(half.mu), device="cpu")
	assert isinstance(carried, stats.MeanState) and carried.n == 16
	_close(stats.mean_update(carried, torch.from_numpy(X[16:])).mu, X.mean(axis=0))


def test_states_only_widen():
	for cls in (stats.Mean, stats.Covariance):
		s = cls(dim=1, dtype=torch.float64, device="cpu")
		s.update(np.ones((4, 1), np.float64))
		s.update(np.ones((4, 1), np.float32))
		assert s.mu.dtype == torch.float64
		s32 = cls(dim=1, dtype=torch.float32, device="cpu")
		s32.update(np.ones((4, 1), np.float64))
		assert s32.mu.dtype == torch.float64
		with pytest.raises(ValueError):
			s32.update(np.ones((4, 2)))


@pytest.mark.parametrize("sdist", ["t", "normal"])
def test_confidence_interval_matches_jax(sdist):
	a = np.random.default_rng(1234).normal(size=200)
	got = stats.confidence_interval(torch.from_numpy(a), 0.95, sdist=sdist)
	_close(got, jstats.confidence_interval(a, 0.95, sdist=sdist))
	assert got[0] < a.mean() < got[1]
	with pytest.raises(ValueError):
		stats.confidence_interval(a, 0.95, sdist="cauchy")
