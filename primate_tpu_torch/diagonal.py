"""Stochastic diagonal estimators: Girard-Hutchinson ``diag``, Diag++ and XDiag.

Counterpart of ``primate_tpu/diagonal.py``. As in :mod:`.trace`, each estimator
is a sampling step (round ``it``'s probes from the generator keyed
``(seed, it)``) and a core that takes the probe blocks. ``diag`` is a Python
loop that enqueues one ``(n, batch)`` operator apply per iteration: a count
criterion decides on the host and never reads the device, any other reads it
once per iteration.
"""

import warnings
from typing import Callable, Optional, Union

import numpy as np
import torch

from .estimators import ConvergenceCriterion, EstimatorResult, EstSnapshot, convergence_criterion
from .linalg import full_f32, tall_qr
from .random import real_dtype
from .trace import _base_seed, _rdot, _sketch_op, probe_sampler

__all__ = ["diag", "diagpp", "xdiag", "xdiag_core", "diagpp_core", "run_diag"]


def run_diag(op, draw: Callable[[int], torch.Tensor], criterion, maxiter: int = 4096, batch: int = 1, full: bool = False):
	"""The ratio-normalised Girard-Hutchinson loop on a probe sampler ``draw(it) → (n, batch)``; see :func:`diag`."""
	N = op.shape[0]
	acc = real_dtype(torch.promote_types(op.dtype, torch.float32))
	zeros = lambda: torch.zeros(N, dtype=acc, device=op.device)  # noqa: E731
	numer, denom, mu, m2, n = zeros(), zeros(), zeros(), zeros(), 0
	delta = torch.full((N,), float("inf"), dtype=acc, device=op.device)

	def snapshot() -> EstSnapshot:
		return EstSnapshot(n=n, estimate=mu, delta=delta, var=torch.mean(m2) / max(n - 1, 1))

	while n < maxiter and not criterion.check(snapshot()):
		V = draw(n)
		U = op.matvec(V[:, 0])[:, None] if batch == 1 else op.matmat(V)
		numer = numer + _rdot(V, U, 1).to(acc)
		denom = denom + _rdot(V, V, 1).to(acc)
		est = numer / torch.where(denom == 0, 1.0, denom)
		new_mu = mu + (est - mu) / (n + 1)
		m2 = m2 + (est - mu) * (est - new_mu)
		delta, mu, n = new_mu - mu, new_mu, n + 1
	if n >= maxiter and not criterion.check(snapshot()):
		warnings.warn(f"diag: stopped by maxiter={maxiter} before the convergence criterion was met", stacklevel=3)
	estimate = mu.cpu().numpy()
	if not full:
		return estimate
	result = EstimatorResult(criterion=criterion, estimate=estimate, nit=n)
	result.info["m2"] = m2
	return estimate, result


def diag(
	A,
	pdf: Union[str, Callable] = "rademacher",
	converge: Union[str, ConvergenceCriterion] = "tolerance",
	seed=None,
	full: bool = False,
	maxiter: int = 4096,
	batch: int = 1,
	**kwargs,
):
	r"""Estimate ``diag(A)`` by the ratio-normalised Girard-Hutchinson estimator
	(``primate_tpu/diagonal.py:285-500``).

	Accumulates ``Σ v∘(Av) / Σ v∘v`` over ``batch`` probes per iteration and
	returns the mean of the running ratios, as the JAX package does. ``converge``
	names a criterion ("tolerance", "count", "confidence") with its keywords, or
	is one; it and ``maxiter`` count iterations. ``result.info["m2"]`` holds the
	per-entry Welford sum of squared deviations.
	"""
	for flag in ("differentiable", "record", "callback", "resume"):
		if kwargs.pop(flag, None):
			raise NotImplementedError(f"{flag} is not ported yet")
	op = _sketch_op(A, "diag")
	criterion = convergence_criterion(converge, **kwargs)
	N = op.shape[0]
	if N == 0:
		return (np.zeros(0), EstimatorResult()) if full else np.zeros(0)
	batch = max(1, int(batch))
	sample = probe_sampler(op, _base_seed(seed), pdf)
	return run_diag(op, lambda it: sample(it, batch), criterion, maxiter=maxiter, batch=batch, full=full)


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


def xdiag(A, m: Optional[int] = None, pdf: str = "sphere", seed=None) -> np.ndarray:
	"""XDiag leave-one-out diagonal estimator (``primate_tpu/diagonal.py:594-616``):
	``m / 2`` probe columns (``m`` rounded up to even, at most ``2n``), ``m`` operator
	applications in two blocks."""
	op = _sketch_op(A, "xdiag")
	n = op.shape[0]
	m = 2 * n if m is None else min(int(m) + (int(m) % 2), 2 * n)
	return xdiag_core(op, probe_sampler(op, _base_seed(seed), pdf)(0, m // 2)).cpu().numpy()
