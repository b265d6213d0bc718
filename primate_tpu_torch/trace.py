"""Girard-Hutchinson trace estimation.

Counterpart of ``hutch`` in ``primate_tpu/trace.py:77-360``. The JAX package
fuses the batch loop into one ``lax.while_loop``; here it is a Python loop that
enqueues each batch's device work. Batch ``it`` draws its probes from a
``torch.Generator`` on the operator's device seeded by ``(seed, it)``, the
counterpart of ``fold_in(key, it)``, so ``resume`` continues the same stream.
A count criterion decides on the host sample count and never reads the
device; adaptive criteria read it once per batch. Not ported yet: a per-batch
``callback``, recorded samples (knee criteria) and ``differentiable=True``.
"""

import warnings
from typing import Callable, Union

import numpy as np
import torch

from .estimators import (
	ConvergenceCriterion,
	EstimatorResult,
	MeanEstimator,
	convergence_criterion,
	default_trace_criterion,
	snapshot_of,
)
from .operators.base import aslinop, is_valid_operator, quad_form
from .random import classify_pdf, real_dtype, sample_isotropic
from .stats import CovState, cov_update, make_cov_state

__all__ = ["hutch"]


def _base_seed(seed) -> int:
	"""An int seed from an int, a numpy Generator or None (fresh OS entropy)."""
	if seed is None:
		return int(np.random.SeedSequence().generate_state(1)[0])
	if isinstance(seed, np.random.Generator):
		return int(seed.integers(0, 2**63 - 1))
	return int(seed)


def batch_generator(seed: int, it: int, device) -> torch.Generator:
	"""The generator of batch ``it``: seeded by ``(seed, it)``, independent of every other batch."""
	g = torch.Generator(device=device)
	g.manual_seed(int(np.random.SeedSequence([seed, it]).generate_state(1, np.uint64)[0] >> np.uint64(1)))
	return g


def hutch(
	A,
	batch: int = 32,
	pdf: Union[str, Callable] = "rademacher",
	converge: Union[str, ConvergenceCriterion] = "default",
	seed=None,
	full: bool = False,
	maxiter: int = 1024,
	resume=None,
	**kwargs,
):
	r"""Estimate ``tr(A)`` for symmetric ``A`` by the Girard-Hutchinson estimator.

	The mean of isotropic quadratic forms ``vᵀAv``. With a :class:`MatrixFunction`
	the operator's batched ``quad`` is used, which makes this stochastic Lanczos
	quadrature for ``tr(f(A))`` (logdet with ``fun="log"``).

	``batch`` probes per iteration; ``pdf`` a distribution name (rademacher,
	normal, sphere), a callable ``(generator, shape, dtype)`` or a numpy-style
	host sampler ``pdf(size=...)``; ``converge`` a criterion name
	("count"/"confidence", keyword arguments routed to it) or instance (default:
	200 samples OR 95% CI within ±1.0); ``seed`` an int, a numpy Generator or
	None; ``full`` also returns an :class:`EstimatorResult`; ``maxiter`` bounds
	the total batches, resumed ones included. ``resume`` continues a run from
	its ``full=True`` result (or its estimator), made with the same
	``A``/``seed``/``batch``/``pdf``: the estimate equals that of one
	uninterrupted run.
	"""
	is_valid_operator(A)
	op = A if hasattr(A, "quad") else aslinop(A)
	if kwargs.pop("differentiable", False):
		raise NotImplementedError("differentiable=True is not ported yet")
	if batch < 1:
		raise ValueError("Batch size must be positive.")
	if getattr(op, "stack_shape", ()):
		raise NotImplementedError("stacked (family-valued) spectral functions are not ported yet")
	N = op.shape[0]
	if converge == "default":
		if kwargs:
			warnings.warn(f"Ignoring criterion kwargs {sorted(kwargs)} because converge='default'", stacklevel=2)
		criterion = default_trace_criterion()
	else:
		criterion = convergence_criterion(converge, **kwargs)

	device = op.device
	acc = real_dtype(torch.promote_types(op.dtype, torch.float32))
	s_dtype = real_dtype(op.dtype)
	pdf_kind = classify_pdf(pdf)
	base = _base_seed(seed)

	state, it = make_cov_state(1, acc, device), 0
	if resume is not None:
		est = resume.estimator if isinstance(resume, EstimatorResult) else resume
		if not (isinstance(est, MeanEstimator) and isinstance(est.state, CovState)):
			raise TypeError("resume expects an EstimatorResult or MeanEstimator from hutch(..., full=True)")
		st = est.state
		if st.n % batch != 0:
			raise ValueError(f"resume state has {st.n} samples, not a multiple of batch={batch}")
		state, it = CovState(st.n, st.mu.to(device, acc), st.S.to(device, acc)), st.n // batch
	delta = torch.full((1,), float("inf"), dtype=acc, device=device)

	while it < maxiter and not criterion.check(snapshot_of(state, delta)):
		if pdf_kind == "size":
			# Reference hot-loop semantics: the stateful sampler draws on the host.
			V = torch.as_tensor(np.asarray(pdf(size=(N, batch))), dtype=s_dtype, device=device)
		else:
			V = sample_isotropic(batch_generator(base, it, device), (N, batch), pdf=pdf, dtype=s_dtype)
		s = quad_form(op, V).to(acc)
		if s.shape != (batch,):
			raise NotImplementedError(f"hutch takes scalar quadratic forms (batch,); got {tuple(s.shape)}")
		new = cov_update(state, s[:, None])
		delta, state = new.mu - state.mu, new
		it += 1

	estimator = MeanEstimator.from_state(state, delta=delta)
	estimate = estimator.estimate
	capped = it >= maxiter and not criterion.check(snapshot_of(state, delta))
	if capped:
		warnings.warn(
			f"hutch: stopped by maxiter={maxiter} before the convergence criterion was met; "
			"resume= from the returned result to continue the same probe stream",
			stacklevel=2,
		)
	if not full:
		return estimate
	result = EstimatorResult(
		estimator=estimator,
		criterion=criterion,
		estimate=estimate,
		message=criterion.message(estimator) if hasattr(criterion, "message") else "",
		nit=state.n,
	)
	if capped:
		result.info["capped"] = True
	return estimate, result
