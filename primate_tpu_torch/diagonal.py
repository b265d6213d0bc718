"""Stochastic diagonal estimators: Girard-Hutchinson ``diag``, Diag++ and XDiag.

Counterpart of ``primate_tpu/diagonal.py``. A Hermitian (complex) operator's
diagonal is real: the ratio is ``Re(conj(v)∘Av) / |v|²`` on real probes or
``pdf="phase"`` ones (``primate_tpu/diagonal.py:221-265,444-465``), and the
sketches conjugate their bras. As in :mod:`.trace`, each estimator
is a sampling step (round ``it``'s probes from the generator keyed
``(seed, it)``) and a core that takes the probe blocks. ``diag`` is a Python
loop that enqueues one ``(n, batch)`` operator apply per iteration: a count
criterion decides on the host and never reads the device, any other reads it
once per iteration, as do a ``callback`` and ``record=True``. A stacked
operator (a ``MatrixFunction`` of a stacked family) gives one diagonal per
member, ``(nt, n)``, from one sweep per iteration.
"""

from typing import Callable, Optional, Union

import numpy as np
import torch

from .estimators import (
	ConvergenceCriterion, EstimatorResult, EstSnapshot, MeanEstimator, convergence_criterion, criterion_needs_values,
	note_capped,
)
from .linalg import full_f32, tall_qr
from .random import classify_pdf, real_dtype
from .stats import MeanState
from .operators.base import aslinop, is_valid_operator
from .trace import _base_seed, _rdot, _sketch_op, check_traced_path, count_budget, estimate_only, probe_sampler

__all__ = ["diag", "diagpp", "xdiag", "xdiag_core", "diagpp_core", "run_diag", "diag_ratio"]


def run_diag(
	op, draw: Callable[[int], torch.Tensor], criterion, maxiter: int = 4096, batch: int = 1, full: bool = False,
	callback: Optional[Callable] = None, record: bool = False, resume=None,
):
	"""The ratio-normalised Girard-Hutchinson loop on a probe sampler ``draw(it) → (n, batch)``; see :func:`diag`."""
	N = op.shape[0]
	acc = real_dtype(torch.promote_types(op.dtype, torch.float32))
	stack_shape = getattr(op, "stack_shape", None)
	if stack_shape is None:  # a callable spectral function: its output shape only a call can tell
		stack_shape = op.matvec(torch.zeros(N, dtype=op.dtype, device=op.device)).shape[:-1]
	stack_shape = tuple(stack_shape)
	nout = int(np.prod(stack_shape)) if stack_shape else 1
	zeros = lambda m: torch.zeros(m, dtype=acc, device=op.device)  # noqa: E731
	numer, denom, mu, m2, n = zeros(nout * N), zeros(N), zeros(nout * N), zeros(nout * N), 0
	if resume is not None:
		st = resume.info["state"] if isinstance(resume, EstimatorResult) else resume
		if "batch" in st and int(st["batch"]) != batch:
			raise ValueError(
				f"resume state was built with batch={st['batch']} but this call uses batch={batch}; "
				"probes are keyed by iteration index, so resuming the same run needs the same batch"
			)
		mean = st["mean"]
		if mean.mu.shape[0] != nout * N:
			raise ValueError(f"resume state dim {mean.mu.shape[0]} != {nout * N}")
		state = lambda x: torch.as_tensor(x, device=op.device).to(acc).clone()  # noqa: E731
		numer, denom, mu, m2, n = state(st["numer"]), state(st["denom"]), state(mean.mu), state(st["m2"]), int(mean.n)
	delta = torch.full((nout * N,), float("inf"), dtype=acc, device=op.device)
	# The JAX package's record: a mean estimator (no covariance) over the running mean, which
	# the callback sees and which keeps the recorded ratio estimates in its ``values``.
	estimator = MeanEstimator.from_state(MeanState(n=n, mu=mu), delta=delta)
	estimator.values = [] if record else None
	result = EstimatorResult(estimator=estimator, criterion=criterion)

	def snapshot() -> EstSnapshot:
		return EstSnapshot(n=n, estimate=mu, delta=delta, var=torch.mean(m2) / max(n - 1, 1))

	def estimate() -> np.ndarray:
		return mu.cpu().numpy().reshape(stack_shape + (N,))

	while n < maxiter and not criterion.check(snapshot()):
		V = draw(n)
		U = op.matvec(V[:, 0])[..., None] if batch == 1 else op.matmat(V)  # (..., N, batch)
		numer = numer + _rdot(V, U, -1).to(acc).reshape(-1)
		denom = denom + _rdot(V, V, -1).to(acc)
		est = (numer.reshape(nout, N) / torch.where(denom == 0, 1.0, denom)).reshape(-1)
		new_mu = mu + (est - mu) / (n + 1)
		m2 = m2 + (est - mu) * (est - new_mu)
		delta, mu, n = new_mu - mu, new_mu, n + 1
		estimator.state, estimator.delta = MeanState(n=n, mu=mu), delta
		if record:
			estimator.values.extend(est.tolist())
		if callback is not None:
			result.estimate, result.nit = estimate(), n
			callback(result)
	capped = n >= maxiter and not criterion.check(snapshot())
	result.estimate, result.nit = estimate(), n
	if not full:
		note_capped(capped, maxiter, name="diag")
		return result.estimate
	result.message = criterion.message(estimator) if hasattr(criterion, "message") else ""
	result.info["state"] = {"batch": batch, "numer": numer, "denom": denom, "mean": MeanState(n=n, mu=mu), "m2": m2}
	note_capped(capped, maxiter, result, name="diag")
	return result.estimate, result


def diag_ratio(op, draw: Callable[[int], torch.Tensor], iters: int) -> torch.Tensor:
	"""The plain ratio estimator ``Σ v∘(Av) / Σ v∘v`` over ``iters`` probe blocks
	``draw(i) → (n, batch)`` (``primate_tpu/diagonal.py:60-122``): ordinary tensor
	operations on the operator's applies, so autograd reaches the operator's tensors.
	Returns ``(n,)``, or ``(nt, n)`` for a stacked operator."""
	N = op.shape[0]
	acc = torch.promote_types(op.dtype, torch.float32)
	stack_shape = tuple(getattr(op, "stack_shape", None) or ())
	nout = int(np.prod(stack_shape)) if stack_shape else 1
	numer = torch.zeros(nout * N, dtype=acc, device=op.device)
	denom = torch.zeros(N, dtype=acc, device=op.device)
	for i in range(iters):
		V = draw(i)
		U = op.matmat(V.to(op.dtype))  # (..., N, batch)
		numer = numer + torch.sum(U.to(acc) * V.to(acc), dim=-1).reshape(numer.shape)
		denom = denom + torch.sum(V.to(acc) * V.to(acc), dim=-1)
	est = (numer.reshape(nout, N) / torch.where(denom == 0, 1.0, denom)).reshape(stack_shape + (N,))
	return est if stack_shape else est.reshape(N)


def _diag_differentiable(op, pdf, converge, seed, maxiter: int, batch: int, kwargs) -> torch.Tensor:
	"""``diag(..., differentiable=True)`` (``primate_tpu/diagonal.py:60-122,331-335``): the
	plain ratio over ``min(count, maxiter)`` iterations of ``batch`` probes, iteration ``i``
	drawn as the count path draws it. ``converge="tolerance"`` without keywords, ``diag``'s
	default, counts as no criterion (a count)."""
	if op.dtype.is_complex:  # primate_tpu/diagonal.py:96-97
		raise NotImplementedError("differentiable diag is real-symmetric only (mirrors autodiff.spectral_sum).")
	if converge == "tolerance" and not kwargs:
		converge = "count"
	count = count_budget("diag", converge, kwargs)
	iters = min(count, int(maxiter))
	note_capped(iters < count, maxiter, name="diag")
	sample = probe_sampler(op, _base_seed(seed), pdf)
	return diag_ratio(op, lambda i: sample(i, batch), iters)


@estimate_only
def diag(
	A,
	pdf: Union[str, Callable] = "rademacher",
	converge: Union[str, ConvergenceCriterion] = "tolerance",
	seed=None,
	full: bool = False,
	callback: Optional[Callable] = None,
	record: bool = False,
	maxiter: int = 4096,
	resume=None,
	batch: int = 1,
	**kwargs,
):
	r"""Estimate ``diag(A)`` by the ratio-normalised Girard-Hutchinson estimator
	(``primate_tpu/diagonal.py:285-500``).

	Accumulates ``Σ v∘(Av) / Σ v∘v`` over ``batch`` probes per iteration and
	returns the mean of the running ratios, as the JAX package does. A stacked
	operator gives ``(nt, n)``. ``converge`` names a criterion ("tolerance",
	"count", "confidence") with its keywords, or is one; it and ``maxiter`` count
	iterations. ``callback(result)`` is called after every iteration with the
	running estimate. With ``full=True`` the record is the JAX package's:
	``result.estimator`` is a :class:`~primate_tpu_torch.estimators.MeanEstimator` over
	the running mean (no covariance), the one the callback sees; ``record=True`` keeps
	every iteration's ratio estimate, flattened, in ``result.estimator.values``;
	``result.message`` is the criterion's; ``result.info`` holds ``state`` (and
	``capped`` after a budget-capped stop). ``pdf`` may also be a numpy-style host sampler
	``pdf(size=...)``, drawn on the host each iteration as the reference does.

	``resume`` continues a run from its ``full=True`` result or its ``result.info["state"]``
	(``batch``, ``numer``, ``denom``, ``mean`` and ``m2``; :func:`~primate_tpu_torch.utils.checkpoint.save_pytree`
	round-trips it), made with the same ``A``/``seed``/``pdf``/``batch``: iteration ``it`` draws
	its probes from the generator keyed ``(seed, it)``, so the resumed estimate equals that of
	one uninterrupted run bit for bit on one device.

	``differentiable=True`` (a count criterion) returns the plain final ratio
	``Σ v∘(Av) / Σ v∘v`` as a tensor with a gradient to the operator's tensors, not
	the mean of the running ratios; ``callback``, ``record``, ``resume`` and ``full``
	are refused there. A ``MatrixFunction`` differentiates through its Lanczos sweeps
	(real operators only, as in JAX).
	"""
	differentiable = kwargs.pop("differentiable", False)
	if differentiable:
		check_traced_path("diag", callback, resume, record, full, pdf)
	is_valid_operator(A)
	op = A if hasattr(A, "quad") else aslinop(A)
	if differentiable:
		return _diag_differentiable(op, pdf, converge, seed, maxiter, max(1, int(batch)), kwargs)
	criterion = convergence_criterion(converge, **kwargs)
	if criterion_needs_values(criterion):
		raise NotImplementedError("Knee-style criteria (recorded-sample based) are not defined for diag's dim-N estimator.")
	N = op.shape[0]
	if N == 0:
		return (np.zeros(0), EstimatorResult()) if full else np.zeros(0)
	batch = max(1, int(batch))
	if classify_pdf(pdf) == "size":
		# Reference semantics (``primate_tpu/diagonal.py:449-453``): the stateful closure draws on
		# the host, one probe (``size=(N,)``) or a block of ``batch`` each iteration.
		def draw(it: int) -> torch.Tensor:
			V = np.asarray(pdf(size=(N, batch) if batch > 1 else (N,))).reshape(N, batch)
			return torch.as_tensor(V, dtype=real_dtype(op.dtype), device=op.device).to(op.dtype)
	else:
		sample = probe_sampler(op, _base_seed(seed), pdf)
		draw = lambda it: sample(it, batch)  # noqa: E731
	return run_diag(
		op, draw, criterion, maxiter=maxiter, batch=batch, full=full, callback=callback, record=record, resume=resume
	)


@full_f32
def diagpp_core(op, S: torch.Tensor, G: torch.Tensor) -> torch.Tensor:
	"""Diag++ on given probe blocks ``S`` (sketch) and ``G`` (residual), both ``(n, nb)``
	(``primate_tpu/diagonal.py:502-531``): the exact diagonal of ``QQᵀA`` plus the
	ratio estimate of the deflated rest. Three operator applies."""
	acc = torch.promote_types(op.dtype, torch.float32)
	Q, _ = tall_qr(op.matmat(S).to(acc))
	AQ = op.matmat(Q.to(op.dtype)).to(acc)
	d1 = torch.sum(Q * AQ.conj(), dim=1)
	Rres = op.matmat(G).to(acc) - Q @ ((AQ.mH if AQ.is_complex() else AQ.T) @ G.to(acc))
	Gr = torch.real(G).to(real_dtype(acc))
	numer = torch.sum(Gr * Rres, dim=1)
	denom = torch.sum(Gr * Gr, dim=1)
	return torch.real(d1 + numer / torch.where(denom == 0, 1.0, denom))


@estimate_only
def diagpp(A, m: Optional[int] = None, pdf: str = "rademacher", seed=None) -> np.ndarray:
	"""Diag++: low-rank deflation + residual Hutchinson (``primate_tpu/diagonal.py:534-557``).
	``nb = m`` (or ``N // 3``) sketch columns and as many residual probes, ``3·nb`` applies."""
	op = _sketch_op(A, "diagpp")
	n = op.shape[0]
	if n == 0:
		return np.zeros(0)
	nb = max(1, min((n // 3) if m is None else int(m), n))
	draw = probe_sampler(op, _base_seed(seed), pdf)
	return diagpp_core(op, draw(0, nb), draw(1, nb)).cpu().numpy()


@full_f32
def xdiag_core(op, Nm: torch.Tensor) -> torch.Tensor:
	"""XDiag's leave-one-out diagonal identities (Epperly SM4.3) on a given probe
	block ``Nm (n, m)`` (``primate_tpu/diagonal.py:561-591``). Two operator applies."""
	m = Nm.shape[1]
	h = lambda X: X.mH if X.is_complex() else X.T  # noqa: E731
	Y = op.matmat(Nm)
	Q, R = tall_qr(Y)
	dNY = torch.sum(Nm * Y.conj(), dim=1)[:, None]
	Z = op.matmat(Q)
	T = h(Z) @ Nm
	R_inv = torch.linalg.solve_triangular(R, torch.eye(m, dtype=R.dtype, device=R.device), upper=True)
	S = h(R_inv) / torch.linalg.vector_norm(R_inv, dim=1)[None, :]
	QS = Q @ S
	dQZ = torch.sum(Q * Z.conj(), dim=1)[:, None]
	dQSSZ = torch.sum(QS * (Z @ S).conj(), dim=1)[:, None]
	dNTQ = torch.sum(Nm * (Q @ T).conj(), dim=1)[:, None]
	dST = torch.sum(S.conj() * T, dim=0)[:, None]
	dNQSST = torch.sum(Nm * (QS * dST[:, 0][None, :]).conj(), dim=1)[:, None]
	d = dQZ + (-dQSSZ + dNY - dNTQ + dNQSST) / m
	return torch.real(d[:, 0])


@estimate_only
def xdiag(A, m: Optional[int] = None, pdf: str = "sphere", seed=None, differentiable: bool = False):
	"""XDiag leave-one-out diagonal estimator (``primate_tpu/diagonal.py:594-616``):
	``m / 2`` probe columns (``m`` rounded up to even, at most ``2n``), ``m`` operator
	applications in two blocks. ``differentiable=True`` returns the tensor, whose
	gradient is the exact derivative of the fixed program."""
	op = _sketch_op(A, "xdiag")
	n = op.shape[0]
	m = 2 * n if m is None else min(int(m) + (int(m) % 2), 2 * n)
	d = xdiag_core(op, probe_sampler(op, _base_seed(seed), pdf)(0, m // 2))
	return d if differentiable else d.cpu().numpy()
