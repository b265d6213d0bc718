"""Four small estimator features against the JAX package: ``diag(resume=)``, ``diag`` with a
numpy-style ``pdf(size=...)`` host sampler, ``xtrace(record=, callback=)`` and ``tqli``'s output
arrays (``tqli(d, e, Z)``).

Probes: a ``size`` sampler is a seeded numpy closure built twice from one seed, so both packages
draw the same probes and agree to float64 rounding (1e-12); ``xtrace`` gets the JAX package's
``fold_in`` probes injected into ``run_xtrace`` (1e-8 relative, as ``test_torch_sketch.py``). A
resumed port run equals one uninterrupted port run bit for bit.
"""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import jax
import jax.numpy as jnp

import primate_tpu as pt
from primate_tpu.operators.sparse import DIAOperator as JaxDIA
from primate_tpu.random import as_key
from primate_tpu.random import sample_isotropic as jax_sample

import primate_tpu_torch as ptt
from primate_tpu_torch import DIAOperator, diag, tqli, xtrace
from primate_tpu_torch.estimators import CountCriterion, KneeCriterion, ToleranceCriterion
from primate_tpu_torch.trace import run_xtrace
from primate_tpu_torch.utils.checkpoint import load_pytree, save_pytree

torch.set_num_threads(1)
N, SEED = 60, 4


def _matrix():
	rng = np.random.default_rng(0)
	offs = (-7, -1, 1, 7)
	A = sps.diags([rng.uniform(-1, 1, N - abs(o)) for o in offs], offs, shape=(N, N))
	A = 0.5 * (A + A.T)
	return (A + sps.diags(np.abs(A).sum(axis=1).A.ravel() + 0.5)).tocsr()


def _operators(kind):
	"""(JAX operator, port operator) of one SPD matrix: DIA or dense."""
	A = _matrix()
	if kind == "dia":
		return JaxDIA.from_scipy(A), DIAOperator.from_scipy(A, device="cpu")
	return jnp.asarray(A.toarray()), torch.from_numpy(A.toarray())


def _sampler(seed):
	"""A stateful numpy Rademacher sampler ``pdf(size=...)``; two built from one seed draw alike."""
	rng = np.random.default_rng(seed)
	return lambda size: rng.choice([-1.0, 1.0], size=size)


# --- diag(resume=) -----------------------------------------------------------------------------


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("kind", ["dia", "dense"])
def test_diag_resume_is_bit_exact(kind, batch, tmp_path):
	"""A run stopped after 4 iterations and resumed to 10, its state through ``save_pytree``/
	``load_pytree``, equals one run of 10 bit for bit, state and all."""
	_, op = _operators(kind)
	whole, wres = diag(op, converge="count", count=10, seed=SEED, batch=batch, full=True)
	_, half = diag(op, converge="count", count=4, seed=SEED, batch=batch, full=True)
	assert half.info["state"]["mean"].n == 4 and half.info["state"]["batch"] == batch
	save_pytree(tmp_path / "state", half.info["state"])
	state = load_pytree(tmp_path / "state", device="cpu")
	for resume in (half, state):
		got, res = diag(op, converge="count", count=10, seed=SEED, batch=batch, full=True, resume=resume)
		assert np.array_equal(got, whole) and res.nit == wres.nit == 10
		for key in ("numer", "denom", "m2"):
			assert torch.equal(res.info["state"][key], wres.info["state"][key])
	with pytest.raises(ValueError, match="batch"):
		diag(op, converge="count", count=10, seed=SEED, batch=batch + 1, resume=half)


@pytest.mark.parametrize("batch", [1, 4])
@pytest.mark.parametrize("kind", ["dia", "dense"])
def test_diag_resume_matches_jax(kind, batch):
	"""The same split run in both packages, on the same host-drawn probes."""
	jop, op = _operators(kind)
	sj, st = _sampler(SEED), _sampler(SEED)
	_, jhalf = pt.diag(jop, pdf=sj, converge="count", count=3, batch=batch, full=True)
	want = np.asarray(pt.diag(jop, pdf=sj, converge="count", count=7, batch=batch, resume=jhalf))
	_, half = diag(op, pdf=st, converge="count", count=3, batch=batch, full=True)
	got = diag(op, pdf=st, converge="count", count=7, batch=batch, resume=half)
	np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


# --- diag with a pdf(size=...) sampler -----------------------------------------------------------


@pytest.mark.parametrize("batch", [1, 4])
@pytest.mark.parametrize("kind", ["dia", "dense"])
def test_diag_size_sampler_matches_jax(kind, batch):
	"""The host sampler drawn each iteration, as JAX draws it: the estimate, the recorded ratio
	estimates and a callback per iteration."""
	jop, op = _operators(kind)
	seen, jseen = [], []
	want, jres = pt.diag(jop, pdf=_sampler(SEED), converge="count", count=5, batch=batch, full=True, record=True,
		callback=lambda r: jseen.append(np.array(r.estimate)))
	got, res = diag(op, pdf=_sampler(SEED), converge="count", count=5, batch=batch, full=True, record=True,
		callback=lambda r: seen.append(np.array(r.estimate)))
	np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-12)
	np.testing.assert_allclose(np.array(seen), np.array(jseen), rtol=0, atol=1e-12)
	np.testing.assert_allclose(np.ravel(res.estimator.values), np.ravel(np.asarray(jres.estimator.values)), rtol=0, atol=1e-12)


def test_the_sketch_estimators_refuse_a_size_sampler():
	_, op = _operators("dense")
	for call in (lambda: ptt.hutchpp(op, pdf=_sampler(1)), lambda: ptt.xdiag(op, pdf=_sampler(1)), lambda: xtrace(op, pdf=_sampler(1))):
		with pytest.raises(NotImplementedError, match="sketch estimators"):
			call()


# --- xtrace(record=, callback=) ------------------------------------------------------------------


def _fold_in_stream(seed, n, pdf):
	key = as_key(seed)
	return lambda it, k: torch.from_numpy(np.array(jax_sample(jax.random.fold_in(key, it), (n, k), pdf=pdf, dtype=jnp.float64)))


@pytest.mark.parametrize("criterion", ["count", "tolerance", "knee"])
def test_xtrace_record_and_callback_match_jax(criterion):
	"""A callback per round (its running estimates) and the recorded leave-one-out estimates of the
	last round, on the JAX package's probes; a knee criterion reads the recorded values."""
	jop, op = _operators("dia")
	crit, kw = {
		"count": (CountCriterion(36), dict(converge="count", count=36)),
		"tolerance": (ToleranceCriterion(rtol=2e-3), dict(converge="tolerance", rtol=2e-3)),
		"knee": (KneeCriterion(S=1.0), dict(converge="knee", S=1.0)),
	}[criterion]
	seen, jseen = [], []
	got, res = run_xtrace(op, _fold_in_stream(SEED, N, "sphere"), 12, True, CountCriterion(N) | crit, full=True,
		callback=lambda r: seen.append((r.nit, r.estimate)), record=True)
	want, jres = pt.xtrace(jop, batch=12, seed=SEED, full=True, record=True, callback=lambda r: jseen.append((r.nit, r.estimate)),
		**kw)
	assert res.nit == jres.nit and [s[0] for s in seen] == [s[0] for s in jseen] and len(seen) >= (criterion != "knee") + 1
	np.testing.assert_allclose([s[1] for s in seen], [s[1] for s in jseen], rtol=1e-8)
	np.testing.assert_allclose(got, want, rtol=1e-8)
	np.testing.assert_allclose(res.estimator.values, np.ravel(np.asarray(jres.estimator.values)), rtol=1e-8)


def test_xtrace_record_and_callback_on_the_public_call():
	"""The port's own probes: one callback a round, the recorded values the last round's estimates,
	and the count path with ``record`` alone unchanged in its estimate."""
	_, op = _operators("dense")
	calls = []
	est, res = xtrace(op, batch=20, seed=SEED, full=True, record=True, callback=lambda r: calls.append(r.nit))
	assert calls == [20, 40, 60] and len(res.estimator.values) == N
	assert abs(est - float(np.mean(res.estimator.values))) <= 1e-9 * abs(est)
	assert xtrace(op, batch=20, seed=SEED, record=True) == xtrace(op, batch=20, seed=SEED) == est
	with pytest.raises(ValueError):
		xtrace(op, batch=20, seed=SEED, differentiable=True, converge="count", count=20, callback=print)


# --- tqli's output arrays ----------------------------------------------------------------------


def _tridiag(n, seed):
	rng = np.random.default_rng(seed)
	return rng.normal(size=n), rng.normal(size=n - 1)


@pytest.mark.parametrize("form", ["positional", "keyword", "empty"])
def test_tqli_output_arrays_match_jax(form):
	"""``tqli(d, e, Z, max_iter)``: eigenvalues written back into a numpy ``d``, eigenvectors (from
	the identity) into a numpy ``Z``; an empty ``Z`` asks for eigenvalues only. Both packages run the
	same float64 rotations."""
	d, e = _tridiag(12, 3)
	T = np.diag(d) + np.diag(e, 1) + np.diag(e, -1)
	outs = {}
	for name, fn in (("port", tqli), ("jax", pt.tridiag.tqli)):
		d_io, Z = d.copy(), (np.empty(0) if form == "empty" else np.zeros((12, 12)))
		ret = fn(d_io, e.copy(), Z=Z, max_iter=60) if form == "keyword" else fn(d_io, e.copy(), Z, 60)
		outs[name] = (d_io, Z, ret)
	(d_p, Z_p, ret), (d_j, Z_j, _) = outs["port"], outs["jax"]
	np.testing.assert_allclose(np.sort(d_p), np.linalg.eigvalsh(T), atol=1e-10)
	np.testing.assert_allclose(d_p, d_j, rtol=0, atol=1e-12)
	if form == "empty":
		assert isinstance(ret, torch.Tensor) and Z_p.size == 0
		return
	np.testing.assert_allclose(Z_p, Z_j, rtol=0, atol=1e-10)
	assert np.linalg.norm(T @ Z_p - Z_p * d_p[None, :]) <= 1e-8
	rw, Zt = ret
	np.testing.assert_array_equal(rw.numpy(), d_p)
	np.testing.assert_array_equal(Zt.numpy(), Z_p)


def test_tqli_keyword_form_leaves_its_inputs():
	d, e = _tridiag(9, 5)
	d_keep = d.copy()
	rw, Z = tqli(d, e, eigenvectors=True, maxiter=60)
	assert np.array_equal(d, d_keep) and Z.shape == (9, 9)
	batch = tqli(torch.from_numpy(np.stack([d, d + 1.0])), torch.from_numpy(np.stack([e, e])), np.zeros((2, 9, 9)))
	np.testing.assert_allclose(np.sort(batch[0][1].numpy()), np.sort(rw.numpy() + 1.0), atol=1e-10)
