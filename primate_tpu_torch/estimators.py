"""Estimator state and stopping rules.

Counterpart of ``primate_tpu/estimators.py:90-311,345-402,490-592,724-``.
A criterion's ``check(snapshot)`` returns a Python bool. The snapshot's sample
count is a host integer, so :class:`CountCriterion` decides without reading the
device; :class:`ConfidenceCriterion` reads the running variance, one device→host
sync per check. ``OrCriterion`` short-circuits, so a met count skips that read.
"""

import inspect
from dataclasses import dataclass, field
from typing import Callable, NamedTuple, Optional, Union

import numpy as np
import torch

from .stats import CovState, cov_matrix, cov_update, make_cov_state

__all__ = [
	"EstSnapshot",
	"ConvergenceCriterion",
	"OrCriterion",
	"CountCriterion",
	"ConfidenceCriterion",
	"ToleranceCriterion",
	"convergence_criterion",
	"default_trace_criterion",
	"MeanEstimator",
	"EstimatorResult",
]


class EstSnapshot(NamedTuple):
	"""The view of an estimator that criteria consume.

	n: samples seen (host int). estimate/delta: ``(dim,)`` tensors. var: ``()``
	tensor, the mean of the per-output sample variances (None when not tracked).
	"""

	n: int
	estimate: torch.Tensor
	delta: torch.Tensor
	var: Optional[torch.Tensor] = None


def snapshot_of(state: CovState, delta: torch.Tensor) -> EstSnapshot:
	var = torch.mean(torch.diagonal(cov_matrix(state, ddof=1)))
	return EstSnapshot(n=state.n, estimate=state.mu, delta=delta, var=var)


class ConvergenceCriterion:
	"""Composable stopping rule; ``crit(est)`` returns a bool. Compose with ``|``."""

	def __init__(self, operation: Optional[Callable] = None):
		self._operation = operation

	def check(self, snap: EstSnapshot) -> bool:
		if self._operation is None:
			raise NotImplementedError("Base criterion requires an operation")
		return bool(self._operation(snap))

	def __call__(self, est) -> bool:
		return self.check(est if isinstance(est, EstSnapshot) else est.snapshot())

	def __or__(self, other: "ConvergenceCriterion"):
		return OrCriterion(self, other)

	def __ror__(self, other):
		return OrCriterion(other, self)

	def message(self, est) -> str:
		return "Composite convergence criterion"


def _child_check(child, snap: EstSnapshot) -> bool:
	return child.check(snap) if isinstance(child, ConvergenceCriterion) else bool(child(snap))


def _child_message(child, est) -> str:
	return child.message(est) if hasattr(child, "message") else getattr(child, "__name__", "<callable criterion>")


class OrCriterion(ConvergenceCriterion):
	def __init__(self, left, right):
		self.left, self.right = left, right

	def check(self, snap: EstSnapshot) -> bool:
		return _child_check(self.left, snap) or _child_check(self.right, snap)

	def message(self, est) -> str:
		return f"{_child_message(self.left, est)} | {_child_message(self.right, est)}"


class CountCriterion(ConvergenceCriterion):
	"""True once at least ``count`` samples have been seen."""

	def __init__(self, count: int = 200):
		self.count = count

	def check(self, snap: EstSnapshot) -> bool:
		return snap.n >= self.count

	def message(self, est) -> str:
		return f"Est: {_summary(est.estimate)} (#S:{est.n_samples})"


def clt_quantiles(confidence: float) -> tuple:
	"""``(z, t_table)`` for a two-sided CLT interval; ``t_table[i]`` has df = i + 1."""
	import scipy.special as spc
	import scipy.stats as st

	z = float(np.sqrt(2.0) * spc.erfinv(confidence))
	t = np.asarray(st.t.ppf((confidence + 1.0) / 2.0, df=np.arange(30) + 1))
	return z, t


class ConfidenceCriterion(ConvergenceCriterion):
	"""CLT-based stopping: the (t / normal) margin of error of the sample mean
	falls below ``atol``, or the relative standard error below ``rtol``."""

	def __init__(self, confidence: float = 0.95, atol: float = 0.0, rtol: float = 0.01):
		if not 0 < confidence < 1:
			raise ValueError("Confidence must be in (0, 1)")
		self.confidence = confidence
		self.atol = 0.0 if atol is None else atol
		self.rtol = 0.0 if rtol is None else rtol
		self.z, self.t_scores = clt_quantiles(confidence)

	def _error(self, snap: EstSnapshot) -> tuple:
		if snap.var is None:
			raise ValueError("ConfidenceCriterion requires a variance-tracking estimator")
		n = snap.n
		if n < 3:
			return np.inf, np.inf
		# One device→host read of the two scalars; float32 as in the JAX package.
		var, est = (float(x) for x in torch.stack([snap.var, snap.estimate[0]]).float().cpu())
		std_err = np.sqrt(np.float32(max(var, 0.0)) / np.float32(n))
		# t-quantile for df = n-1 lives at index n-2 (t_scores[i] has df = i+1).
		score = self.t_scores[min(n - 2, 29)] if n < 30 else self.z
		rel = np.inf if est == 0 else abs(std_err / est)
		return float(score * std_err), float(rel)

	def check(self, snap: EstSnapshot) -> bool:
		moe, rel = self._error(snap)
		return moe <= self.atol or rel <= self.rtol

	def message(self, est) -> str:
		moe, _ = self._error(est.snapshot())
		return f"Est: {_summary(est.estimate)} +/- {moe:.3f} ({self.confidence * 100:.0f}% CI, #S:{est.n_samples})"


class ToleranceCriterion(ConvergenceCriterion):
	"""True when the last mean update is small: ``‖Δ‖ < atol`` or ``‖Δ‖ < rtol·‖estimate‖``
	(``primate_tpu/estimators.py:312-331``). One device→host read per check."""

	def __init__(self, rtol: float = 0.01, atol: float = 1.49e-08, ord: Union[str, float, None] = 2.0):
		self.rtol, self.atol, self.ord = rtol, atol, ord

	def check(self, snap: EstSnapshot) -> bool:
		norm = lambda x: torch.linalg.norm(torch.atleast_1d(x), ord=self.ord)  # noqa: E731
		err, est = (float(x) for x in torch.stack([norm(snap.delta), norm(snap.estimate)]).cpu())
		return err < self.atol or err < self.rtol * est


CRITERIA = {"count": CountCriterion, "confidence": ConfidenceCriterion, "tolerance": ToleranceCriterion}


def convergence_criterion(criterion: Union[str, ConvergenceCriterion], **kwargs) -> ConvergenceCriterion:
	"""Resolve a criterion name (with its keyword arguments) or pass a criterion or callable through."""
	if isinstance(criterion, ConvergenceCriterion) or (callable(criterion) and not isinstance(criterion, str)):
		return criterion
	if not (isinstance(criterion, str) and criterion.lower() in CRITERIA):
		raise ValueError(f"Invalid criterion {criterion} (ported: {sorted(CRITERIA)})")
	crit_cls = CRITERIA[criterion.lower()]
	accepted = inspect.signature(crit_cls.__init__).parameters
	return crit_cls(**{k: v for k, v in kwargs.items() if k in accepted})


def default_trace_criterion() -> ConvergenceCriterion:
	"""The reference's default for `hutch`: 200 samples OR 95% CI within ±1.0."""
	return CountCriterion(count=200) | ConfidenceCriterion(confidence=0.95, atol=1.0, rtol=0.0)


def _summary(x) -> str:
	x = np.atleast_1d(np.asarray(x, dtype=float))
	return f"{x.item():.3f}" if x.size == 1 else np.array2string(x, precision=2, threshold=3)


class MeanEstimator:
	"""Sample-mean estimator over a Welford :class:`~primate_tpu_torch.stats.CovState`."""

	def __init__(self, dim: int = 1, dtype=torch.float64, device="cuda"):
		self.state = make_cov_state(dim, dtype, device)
		self.delta = torch.full((dim,), float("inf"), dtype=dtype, device=device)

	@classmethod
	def from_state(cls, state: CovState, delta: Optional[torch.Tensor] = None) -> "MeanEstimator":
		obj = cls.__new__(cls)
		obj.state = state
		obj.delta = torch.full_like(state.mu, float("inf")) if delta is None else delta
		return obj

	@property
	def dim(self) -> int:
		return self.state.mu.shape[0]

	@property
	def n_samples(self) -> int:
		return self.state.n

	def __len__(self) -> int:
		return self.n_samples

	@property
	def mean(self):
		mu = self.state.mu.cpu().numpy()
		return float(mu[0]) if self.dim == 1 else mu

	@property
	def estimate(self):
		if self.n_samples == 0:
			return np.nan if self.dim == 1 else np.full(self.dim, np.nan)
		return self.mean

	@property
	def converged_variance(self):
		cov = cov_matrix(self.state, ddof=1).cpu().numpy()
		return float(cov[0, 0]) if self.dim == 1 else cov

	def update(self, x) -> None:
		x = torch.as_tensor(x, dtype=self.state.mu.dtype, device=self.state.mu.device)
		x = torch.atleast_1d(x)
		old_mu = self.state.mu
		self.state = cov_update(self.state, x[:, None] if x.ndim == 1 else x)
		self.delta = self.state.mu - old_mu

	def snapshot(self) -> EstSnapshot:
		return snapshot_of(self.state, self.delta)


@dataclass
class EstimatorResult:
	"""Result record for the statistical estimators."""

	estimator: Optional[MeanEstimator] = None
	criterion: Union[ConvergenceCriterion, str, None] = None
	estimate: Union[float, np.ndarray] = 0.0
	message: str = ""
	nit: int = 0
	info: dict = field(default_factory=dict)
