"""Stochastic trace estimators: Girard-Hutchinson, Hutch++, XTrace, XNysTrace.

Counterpart of ``primate_tpu/trace.py``. ``hutch``: the JAX package
fuses the batch loop into one ``lax.while_loop``; here it is a Python loop that
enqueues each batch's device work. Batch ``it`` draws its probes from a
``torch.Generator`` on the operator's device seeded by ``(seed, it)``, the
counterpart of ``fold_in(key, it)``, so ``resume`` continues the same stream.
A count criterion decides on the host sample count and never reads the
device; adaptive criteria read it once per batch. Not ported yet: a per-batch
``callback``, recorded samples (knee criteria) and ``differentiable=True``.

The sketch estimators (``hutchpp``, ``xtrace``, ``xnystrace``) split into a
sampling step, which draws round ``it``'s probes from the generator keyed by
``(seed, it)``, and a core that takes the probe blocks, so the same probes can
be handed to this package and to the JAX one. Their dense algebra (GEMMs,
QR, Cholesky, triangular solves) runs in full float32 on the card
(:func:`~primate_tpu_torch.linalg.full_f32_matmul`); the operator applies run the
sparse kernels.
"""

import warnings
from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch

from .estimators import (
	ConvergenceCriterion,
	CountCriterion,
	EstimatorResult,
	MeanEstimator,
	OrCriterion,
	convergence_criterion,
	default_trace_criterion,
	snapshot_of,
)
from .linalg import colwise_dot, full_f32, qr_append, tall_qr, update_trinv_block
from .operators.base import DeflatedOperator, aslinop, is_valid_operator, quad_form
from .random import classify_pdf, real_dtype, sample_isotropic
from .stats import CovState, cov_update, make_cov_state

__all__ = ["hutch", "hutchpp", "xtrace", "xnystrace"]


def _base_seed(seed) -> int:
	"""An int seed from an int, a numpy Generator or None (fresh OS entropy)."""
	if seed is None:
		return int(np.random.SeedSequence().generate_state(1)[0])
	if isinstance(seed, np.random.Generator):
		return int(seed.integers(0, 2**63 - 1))
	return int(seed)


def _sub_seed(seed: int, it: int) -> int:
	return int(np.random.SeedSequence([seed, it]).generate_state(1, np.uint64)[0] >> np.uint64(1))


def batch_generator(seed: int, it: int, device) -> torch.Generator:
	"""The generator of batch ``it``: seeded by ``(seed, it)``, independent of every other batch."""
	g = torch.Generator(device=device)
	g.manual_seed(_sub_seed(seed, it))
	return g


def probe_sampler(op, base: int, pdf) -> Callable[[int, int], torch.Tensor]:
	"""``draw(it, k)``: round ``it``'s ``(n, k)`` probe block from the generator keyed
	``(base, it)``, real, in the operator's dtype and on its device."""
	if classify_pdf(pdf) == "size":
		raise NotImplementedError("the sketch estimators draw probes on the device; pass a pdf name or a (generator, shape, dtype) callable")
	n, device = op.shape[0], op.device

	def draw(it: int, k: int) -> torch.Tensor:
		V = sample_isotropic(batch_generator(base, it, device), (n, k), pdf=pdf, dtype=real_dtype(op.dtype))
		return V.to(op.dtype)

	return draw


def _sketch_op(A, name: str):
	is_valid_operator(A)
	op = A if hasattr(A, "quad") else aslinop(A)
	if getattr(op, "stack_shape", ()):
		raise NotImplementedError(f"{name} does not support stacked (family-valued) operators")
	return op


def count_only_target(criterion) -> Optional[int]:
	"""The stop count of a criterion that depends only on the sample count
	(a ``CountCriterion`` or an OR of them), else None: its schedule is known
	ahead, so no round needs a device→host read."""
	if isinstance(criterion, CountCriterion):
		return int(criterion.count)
	if isinstance(criterion, OrCriterion):
		a, b = count_only_target(criterion.left), count_only_target(criterion.right)
		return None if a is None or b is None else min(a, b)
	return None


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


def _rdot(X: torch.Tensor, Y: torch.Tensor, dim: int) -> torch.Tensor:
	"""Real part of ``Σ conj(X)·Y`` along ``dim`` (a plain sum of products for real tensors)."""
	return torch.real(torch.sum(X.conj() * Y, dim=dim)) if X.is_complex() else torch.sum(X * Y, dim=dim)


@full_f32
def hutchpp_core(op, W: torch.Tensor, G: torch.Tensor, mode: str = "reduced") -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
	"""Hutch++ on given probe blocks ``W`` (sketch) and ``G`` (residual), both
	``(n, nb)`` (``primate_tpu/trace.py:363-388``): three operator applies.
	Returns ``(estimate, sketch terms (nb,), residual terms (nb,))`` on the device."""
	Q, _ = tall_qr(op.matmat(W))
	if mode == "full":
		rng_ests = _rdot(op.matmat(Q), Q, 0)
	else:
		rng_ests = quad_form(op, Q)
	G = G - Q @ ((Q.mH if Q.is_complex() else Q.T) @ G)
	defl_ests = _rdot(G, op.matmat(G), 0)
	return torch.sum(rng_ests) + torch.sum(defl_ests) / G.shape[1], rng_ests, defl_ests


@full_f32
def hutchpp_sketch(op, W: torch.Tensor) -> Tuple[torch.Tensor, float]:
	"""The sketch of adaptive Hutch++: ``Q`` of ``qr(A W)`` and the exact ``tr(QᵀAQ)``."""
	acc = torch.promote_types(op.dtype, torch.float32)
	Q, _ = tall_qr(op.matmat(W).to(acc))
	Q = Q.to(op.dtype)
	return Q, float(torch.sum(_rdot(op.matmat(Q).to(acc), Q.to(acc), 0)))


def hutchpp(
	A,
	m: Optional[int] = None,
	batch: int = 32,
	mode: str = "reduced",
	pdf: Union[str, Callable] = "rademacher",
	seed=None,
	full: bool = False,
	converge: Union[str, ConvergenceCriterion, None] = None,
	**kwargs,
):
	"""Hutch++ trace estimator: rank-``nb`` deflation + residual Hutchinson
	(``primate_tpu/trace.py:391-476``).

	``nb = m`` (or ``N // 3``) rounded up to a multiple of 3, at least 3; ``3·nb``
	operator applications (``nit``). ``mode="full"`` takes the sketch term as
	``⟨AQ, Q⟩`` even for an operator with a ``quad``. With ``converge`` (and its
	criterion keywords), the residual is estimated by the adaptive :func:`hutch`
	on the deflated operator ``P A P`` instead, and ``result.info`` carries
	``sketch_trace`` and ``sketch_rank``. Probes: the sketch block is round 0 of
	``seed``, the residual block round 1; the adaptive residual runs
	:func:`hutch` with a seed derived from ``seed``.
	"""
	if batch < 1:
		raise ValueError("Batch size must be positive.")
	if kwargs.pop("differentiable", False):
		raise NotImplementedError("differentiable=True is not ported yet")
	if mode not in ("reduced", "full"):
		raise ValueError(f"mode must be 'reduced' or 'full', got {mode!r}")
	op = _sketch_op(A, "hutchpp")
	N = op.shape[0]
	if N == 0:
		return (0.0, EstimatorResult()) if full else 0.0
	nb = (N // 3) if m is None else int(m)
	nb = max(3, nb + (-nb) % 3)
	base = _base_seed(seed)
	draw = probe_sampler(op, base, pdf)
	if converge is not None:
		Q, sketch_trace = hutchpp_sketch(op, draw(0, nb))
		rest = hutch(DeflatedOperator(op, Q), batch=batch, pdf=pdf, converge=converge, seed=_sub_seed(base, 1), full=full, **kwargs)
		if not full:
			return sketch_trace + rest
		rest_est, result = rest
		result.estimate = sketch_trace + rest_est
		result.info["sketch_trace"] = sketch_trace
		result.info["sketch_rank"] = nb
		result.nit += 2 * nb
		return result.estimate, result
	est, rng_ests, defl_ests = hutchpp_core(op, draw(0, nb), draw(1, nb), mode)
	est = float(est)
	if not full:
		return est
	result = EstimatorResult(estimate=est, nit=3 * nb)
	result.info["samples"] = torch.cat([rng_ests, defl_ests]).cpu().numpy()
	return est, result


@full_f32
def xnystrace_core(op, Om: torch.Tensor) -> torch.Tensor:
	"""All ``m`` leave-one-out Nyström trace estimates of a PSD operator from one
	probe block ``Om (n, m)`` (``primate_tpu/trace.py:479-518``): one apply, a
	Cholesky, one ``m×m`` triangular inverse and GEMMs; the stabilising shift
	``ν`` is subtracted exactly at the end."""
	n, m = Om.shape
	acc = torch.promote_types(op.dtype, torch.float32)
	r_acc = real_dtype(acc)
	Y = op.matmat(Om).to(acc)
	Om = Om.to(acc)
	nu = torch.finfo(r_acc).eps * torch.linalg.vector_norm(Y) / float(np.sqrt(n))
	Y = Y + nu * Om
	H = (Om.mH if Om.is_complex() else Om.T) @ Y
	L = torch.linalg.cholesky(0.5 * (H + (H.mH if H.is_complex() else H.T)))
	L_inv = torch.linalg.solve_triangular(L, torch.eye(m, dtype=acc, device=L.device), upper=False)
	B = Y @ (L_inv.mH if L_inv.is_complex() else L_inv.T)
	BL = B @ L_inv
	tr_pg = torch.sum(torch.abs(B) ** 2)
	pgp = torch.sum(torch.abs(BL) ** 2, dim=0)
	p = torch.sum(torch.abs(L_inv) ** 2, dim=0)
	return tr_pg + (1.0 - pgp) / p - nu * n


def xnystrace(A, m: Optional[int] = None, pdf: Union[str, Callable] = "normal", seed=None, full: bool = False):
	"""XNysTrace: leave-one-out Nyström trace estimator for PSD operators
	(``primate_tpu/trace.py:521-581``). ``m`` (default ``N // 3``, clamped to
	``[2, N]``) operator applications, one block."""
	op = _sketch_op(A, "xnystrace")
	N = op.shape[0]
	acc = real_dtype(torch.promote_types(op.dtype, torch.float32))
	if N < 3:
		est = float(torch.sum(quad_form(op, torch.eye(N, dtype=op.dtype, device=op.device)))) if N else 0.0
		return (est, EstimatorResult(estimate=est, nit=N)) if full else est
	m_ = (N // 3) if m is None else int(m)
	m_ = min(max(2, m_), N)
	t = xnystrace_core(op, probe_sampler(op, _base_seed(seed), pdf)(0, m_))
	estimator = MeanEstimator(1, acc, op.device)
	estimator.update(t.to(acc))
	est = estimator.estimate
	if not full:
		return est
	result = EstimatorResult(estimator=estimator, estimate=est, nit=m_)
	result.info["samples"] = t.cpu().numpy()
	return est, result


@full_f32
def xtrace_estimates(W, Z, Q, R, R_inv, sphere: bool) -> torch.Tensor:
	"""Epperly's leave-one-out trace identities over all ``m`` probes
	(``primate_tpu/trace.py:585-624``): ``(m × m)`` GEMMs and columnwise reductions."""
	n, m = W.shape
	cdot = colwise_dot
	h = lambda X: X.mH if X.is_complex() else X.T  # noqa: E731
	W_proj = h(Q) @ W
	S = h(R_inv) / torch.linalg.vector_norm(R_inv, dim=1)[None, :]  # unit columns ∝ R⁻ᴴeᵢ
	dSW = cdot(S, W_proj)
	if sphere:
		scale = (n - m + 1) / (n - torch.linalg.vector_norm(W_proj, dim=0)[:, None] ** 2 + torch.abs(dSW) ** 2)
	else:
		scale = 1.0
	H = h(Q) @ Z
	HW = H @ W_proj
	T = h(Z) @ W
	dSHS = cdot(S, H @ S)
	dTW = cdot(T, W_proj)
	dWHW = cdot(W_proj, HW)
	dSRmHW = cdot(S, R - HW)
	dTmHRS = cdot(T - h(H) @ W_proj, S)
	tr_ests = torch.trace(H) - dSHS
	tr_ests = tr_ests + (-dTW + dWHW + dSW.conj() * dSRmHW + torch.abs(dSW) ** 2 * dSHS + dTmHRS * dSW) * scale
	return torch.real(tr_ests[:, 0])


@full_f32
def xtrace_round(op, state, Nnew: torch.Tensor):
	"""One XTrace growth round (``primate_tpu/trace.py:647-680``): apply the
	operator to the new probes, append them to the QR of the sketch, update the
	triangular inverse, and apply the operator to the new basis columns. Two
	operator applies. ``state`` is ``(W, Z, Q, R, R_inv)`` or None."""
	ns = Nnew.shape[1]
	Ynew = op.matmat(Nnew)
	if state is None:
		Q, R = qr_append(None, None, Ynew)
		empty = torch.zeros((0, 0), dtype=R.dtype, device=R.device)
		R_inv = update_trinv_block(empty, torch.zeros((0, ns), dtype=R.dtype, device=R.device), R)
		return Nnew, op.matmat(Q), Q, R, R_inv
	W, Z, Q, R, R_inv = state
	m_cur = W.shape[1]
	Q, R = qr_append(Q, R, Ynew)
	R_inv = update_trinv_block(R_inv, R[:m_cur, m_cur:], R[m_cur:, m_cur:])
	return torch.cat([W, Nnew], dim=1), torch.cat([Z, op.matmat(Q[:, -ns:])], dim=1), Q, R, R_inv


_STATE_KEYS = ("W", "Z", "Q", "R", "R_inv")


def xtrace(
	A,
	batch: int = 32,
	pdf: Union[str, Callable] = "sphere",
	converge: Union[str, ConvergenceCriterion] = "default",
	seed=None,
	full: bool = False,
	resume=None,
	**kwargs,
):
	"""XTrace: exchangeable leave-one-out trace estimator (``primate_tpu/trace.py:717-911``).

	Grows an orthogonal test subspace by ``batch`` probes per round (round
	``it``'s probes come from the generator keyed ``(seed, it)``) and recomputes
	all ``m`` leave-one-out estimates from it; exact to rounding at ``m = n``.
	Default stop: ``m = n``; a user criterion ORs with that bound. A criterion
	that depends only on the sample count runs every round without reading the
	device and syncs once at the end; any other reads the estimate once per
	round, with ``delta`` the round-over-round move of the estimate.
	``result.info["state"]`` holds the grown subspace; ``resume=`` (that dict or
	the result) continues a run made with the same ``A``/``seed``/``batch``/``pdf``
	bit-exactly.
	"""
	if batch < 1:
		raise ValueError("Batch size must be positive.")
	for flag in ("differentiable", "record", "callback"):
		if kwargs.pop(flag, None):
			raise NotImplementedError(f"{flag} is not ported yet")
	op = _sketch_op(A, "xtrace")
	criterion = CountCriterion(count=op.shape[0])
	if converge != "default":
		criterion = criterion | convergence_criterion(converge, **kwargs)
	elif kwargs:
		warnings.warn(f"Ignoring criterion kwargs {sorted(kwargs)} because converge='default'", stacklevel=2)
	return run_xtrace(op, probe_sampler(op, _base_seed(seed), pdf), batch, pdf == "sphere", criterion, full, resume)


def run_xtrace(op, draw, batch: int, sphere: bool, criterion, full: bool = False, resume=None):
	"""The XTrace loop on a probe sampler ``draw(it, k)``; see :func:`xtrace`."""
	n = op.shape[0]
	acc = real_dtype(torch.promote_types(op.dtype, torch.float32))
	state, it0 = None, 0
	if resume is not None:
		st = resume.info["state"] if isinstance(resume, EstimatorResult) else resume
		if st["W"].shape[0] != n:
			raise ValueError(f"resume state has {st['W'].shape[0]} rows, the operator has {n}")
		it0 = int(st["it"])
		if st["W"].shape[1]:
			state = tuple(torch.as_tensor(st[k], dtype=op.dtype, device=op.device) for k in _STATE_KEYS)

	def m_of(state) -> int:
		return 0 if state is None else state[0].shape[1]

	estimator = MeanEstimator(1, acc, op.device)
	result = EstimatorResult(criterion=criterion)
	target = count_only_target(criterion)
	if target is not None:
		# The schedule is known ahead: run every round without a device read.
		while m_of(state) < min(target, n):
			state = xtrace_round(op, state, draw(it0, min(n - m_of(state), batch)))
			it0 += 1
	else:
		prev = None
		while not criterion(estimator):
			ns = min(n - m_of(state), batch)
			if ns <= 0:
				break
			state = xtrace_round(op, state, draw(it0, ns))
			it0 += 1
			estimator = MeanEstimator(1, acc, op.device)
			estimator.update(xtrace_estimates(*state, sphere).to(acc))
			cur = estimator.state.mu
			estimator.delta = torch.full_like(cur, float("inf")) if prev is None else cur - prev
			prev = cur
	if estimator.n_samples == 0 and m_of(state) > 0:
		estimator.update(xtrace_estimates(*state, sphere).to(acc))
	result.estimator, result.estimate, result.nit = estimator, estimator.estimate, estimator.n_samples
	if state is None:
		state = tuple(torch.zeros(shape, dtype=op.dtype, device=op.device) for shape in [(n, 0)] * 3 + [(0, 0)] * 2)
	result.info["state"] = {**dict(zip(_STATE_KEYS, state)), "it": it0}
	return (result.estimate, result) if full else result.estimate
