"""Estimator state and stopping rules.

Counterpart of ``primate_tpu/estimators.py``. A criterion's ``check(snapshot)``
returns a Python bool. The snapshot's sample count is a host integer, so
:class:`CountCriterion` decides without reading the device;
:class:`ConfidenceCriterion` reads the running variance, one device→host sync per
check, and :class:`KneeCriterion` the recorded samples. ``|`` and ``&`` short-circuit,
so a decided count skips those reads; ``~`` negates.
"""

import inspect
import typing
import warnings
from dataclasses import dataclass, field
from typing import Callable, Iterator, NamedTuple, Optional, Union

import numpy as np
import torch

from .stats import CovState, MeanState, cov_matrix, cov_update, make_cov_state, make_mean_state, mean_update

__all__ = [
	"EstSnapshot",
	"ConvergenceCriterion",
	"OrCriterion",
	"AndCriterion",
	"NotCriterion",
	"CountCriterion",
	"ConfidenceCriterion",
	"ToleranceCriterion",
	"KneeCriterion",
	"convergence_criterion",
	"criterion_needs_values",
	"default_trace_criterion",
	"MeanEstimator",
	"ConfidenceEstimator",
	"ControlVariableEstimator",
	"EstimatorResult",
	"CRITERIA",
	"Estimator",
	"arr_summary",
	"note_capped",
]


def note_capped(capped: bool, maxiter: int, result: "EstimatorResult" = None, name: str = "estimator") -> None:
	"""A budget-capped stop made visible (``primate_tpu/estimators.py:55-72``): when a loop used up
	``maxiter`` with its criterion unmet, warn, and, given the result record, set
	``info["capped"]`` and append ``[capped at maxiter=N]`` to its ``message``."""
	if not capped:
		return
	warnings.warn(
		f"{name}: stopped by maxiter={maxiter} before the convergence criterion was met; "
		"the estimate may not have the requested accuracy/confidence (raise maxiter, or "
		"resume= from the returned result to continue the same probe stream)",
		stacklevel=3,
	)
	if result is not None:
		result.info["capped"] = True
		result.message = (result.message + " " if result.message else "") + f"[capped at maxiter={maxiter}]"


def arr_summary(x) -> str:
	"""A short print of an array for criterion messages (``primate_tpu/estimators.py:75-88``)."""
	if x is None:
		return "None"
	if isinstance(x, torch.Tensor):
		x = x.detach().cpu()
	x = np.atleast_1d(np.asarray(x))
	with np.printoptions(precision=2, suppress=True, threshold=3, floatmode="fixed"):
		if len(x) == 1:
			return f"{x.item():.3f}"
		elif len(x) <= 3:
			return np.array2string(x, separator=",")
		x1 = np.array2string(x[:2], separator=",").strip("[]")
		x2 = np.array2string(x[-1], separator=",").strip("[]")
		return "[" + x1 + ",...," + x2 + "]"


class Estimator(typing.Protocol):
	"""The estimator protocol (``primate_tpu/estimators.py:112-122``): sample count, update, estimate."""

	n_samples: int

	def __len__(self) -> int: ...

	def update(self, x) -> None: ...

	@property
	def estimate(self): ...


class EstSnapshot(NamedTuple):
	"""The view of an estimator that criteria consume.

	n: samples seen (host int). estimate/delta: ``(dim,)`` tensors. var: ``()``
	tensor, the mean of the per-output sample variances (None when not tracked).
	values: ``(n,)`` tensor of the recorded samples (None when not recording).
	"""

	n: int
	estimate: torch.Tensor
	delta: torch.Tensor
	var: Optional[torch.Tensor] = None
	values: Optional[torch.Tensor] = None

	@property
	def n_samples(self) -> int:
		"""Alias for criteria written against the estimator protocol."""
		return self.n


def snapshot_of(state: Union[MeanState, CovState], delta: torch.Tensor, values: Optional[torch.Tensor] = None) -> EstSnapshot:
	var = torch.mean(torch.diagonal(cov_matrix(state, ddof=1))) if isinstance(state, CovState) else None
	return EstSnapshot(n=state.n, estimate=state.mu, delta=delta, var=var, values=values)


class ConvergenceCriterion:
	"""Composable stopping rule; ``crit(est)`` returns a bool. Compose with ``|``, ``&`` and ``~``."""

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

	def __and__(self, other: "ConvergenceCriterion"):
		return AndCriterion(self, other)

	def __rand__(self, other):
		return AndCriterion(other, self)

	def __invert__(self):
		return NotCriterion(self)

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


class AndCriterion(ConvergenceCriterion):
	def __init__(self, left, right):
		self.left, self.right = left, right

	def check(self, snap: EstSnapshot) -> bool:
		return _child_check(self.left, snap) and _child_check(self.right, snap)

	def message(self, est) -> str:
		return f"{_child_message(self.left, est)} & {_child_message(self.right, est)}"


class NotCriterion(ConvergenceCriterion):
	def __init__(self, inner):
		self.inner = inner

	def check(self, snap: EstSnapshot) -> bool:
		return not _child_check(self.inner, snap)

	def message(self, est) -> str:
		return f"~({_child_message(self.inner, est)})"


class CountCriterion(ConvergenceCriterion):
	"""True once at least ``count`` samples have been seen."""

	def __init__(self, count: int = 200):
		self.count = count

	def check(self, snap: EstSnapshot) -> bool:
		return snap.n >= self.count

	def message(self, est) -> str:
		return f"Est: {arr_summary(est.estimate)} (#S:{est.n_samples})"


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
		snap = est if isinstance(est, EstSnapshot) else est.snapshot()
		if snap.var is None:  # an estimator without variance tracking
			return f"Est: {arr_summary(est.estimate)} (#S:{est.n_samples}; variance untracked)"
		moe, _ = self._error(snap)
		return f"Est: {arr_summary(est.estimate)} +/- {moe:.3f} ({self.confidence * 100:.0f}% CI, #S:{est.n_samples})"


class ToleranceCriterion(ConvergenceCriterion):
	"""True when the last mean update is small: ``‖Δ‖ < atol`` or ``‖Δ‖ < rtol·‖estimate‖``
	(``primate_tpu/estimators.py:312-331``). One device→host read per check."""

	def __init__(self, rtol: float = 0.01, atol: float = 1.49e-08, ord: Union[str, float, None] = 2.0):
		self.rtol, self.atol, self.ord = rtol, atol, ord

	def check(self, snap: EstSnapshot) -> bool:
		norm = lambda x: torch.linalg.norm(torch.atleast_1d(x), ord=self.ord)  # noqa: E731
		err, est = (float(x) for x in torch.stack([norm(snap.delta), norm(snap.estimate)]).cpu())
		return err < self.atol or err < self.rtol * est

	def message(self, est) -> str:
		snap = est if isinstance(est, EstSnapshot) else est.snapshot()
		norm = lambda x: float(torch.linalg.norm(torch.atleast_1d(x), ord=self.ord))  # noqa: E731
		return (
			f"Est: {arr_summary(snap.estimate)}(atol={float(self.atol):3f}, rtol={float(self.rtol):3f}, #S:{snap.n})"
			f"\nnorm(it - est, {self.ord}) = {norm(snap.delta):.3f}, norm(est, {self.ord}) = {norm(snap.estimate):.3f}"
		)


class KneeCriterion(ConvergenceCriterion):
	"""Kneedle knee detection on the cumulative-mean difference curve of the
	recorded samples (``primate_tpu/estimators.py:402-453``), in float32 on the
	host as the JAX package computes it; False without recorded samples or
	before 3. One device→host read of the samples per check."""

	def __init__(self, S: float = 1.0):
		self.S = S

	def check(self, snap: EstSnapshot) -> bool:
		m = int(snap.n)
		if snap.values is None or m < 3:
			return False
		v = torch.as_tensor(snap.values)[:m].detach().cpu().numpy().astype(np.float32)
		cum_mean = np.cumsum(v, dtype=np.float32) / np.arange(1, m + 1, dtype=np.float32)
		y = np.cumsum(np.abs(np.diff(cum_mean)), dtype=np.float32)  # (m - 1,)
		y_min, y_max = y.min(), y.max()
		y_norm = (y - y_min) / (y_max - y_min if y_max > y_min else np.float32(1.0))
		mlen = np.float32(max(m - 1, 2))
		x_norm = np.arange(m - 1, dtype=np.float32) / max(mlen - np.float32(1.0), np.float32(1.0))
		diff_curve = y_norm - x_norm
		max_diff = diff_curve[int(np.argmax(diff_curve))]
		threshold = max_diff - np.float32(self.S) / max(mlen - np.float32(1.0), np.float32(1.0))
		return bool(max_diff > threshold and diff_curve[m - 2] < threshold)

	def message(self, est) -> str:
		snap = est if isinstance(est, EstSnapshot) else est.snapshot()
		return f"Est: {arr_summary(snap.estimate.cpu())} (#S:{snap.n}, S={float(self.S):3f})"


CRITERIA = {"count": CountCriterion, "confidence": ConfidenceCriterion, "tolerance": ToleranceCriterion, "knee": KneeCriterion}


def convergence_criterion(criterion: Union[str, ConvergenceCriterion], **kwargs) -> ConvergenceCriterion:
	"""Resolve a criterion name (with its keyword arguments) or pass a criterion or callable through.

	A keyword the named criterion does not take raises ``TypeError`` (the JAX
	package drops it without a word)."""
	if isinstance(criterion, ConvergenceCriterion) or (callable(criterion) and not isinstance(criterion, str)):
		if kwargs:
			raise TypeError(f"criterion keywords {sorted(kwargs)} given with a criterion instance")
		return criterion
	if not (isinstance(criterion, str) and criterion.lower() in CRITERIA):
		raise ValueError(f"Invalid criterion {criterion} (ported: {sorted(CRITERIA)})")
	crit_cls = CRITERIA[criterion.lower()]
	accepted = set(inspect.signature(crit_cls.__init__).parameters) - {"self"}
	unknown = sorted(set(kwargs) - accepted)
	if unknown:
		raise TypeError(f"{crit_cls.__name__} got unexpected keyword arguments {unknown}")
	return crit_cls(**kwargs)


def criterion_needs_values(criterion) -> bool:
	"""Whether any node of a (composed) criterion reads the recorded samples (a knee criterion)."""
	if isinstance(criterion, KneeCriterion) or getattr(criterion, "needs_values", False):
		return True
	children = [getattr(criterion, a, None) for a in ("left", "right", "inner")]
	return any(c is not None and criterion_needs_values(c) for c in children)


def default_trace_criterion() -> ConvergenceCriterion:
	"""The reference's default for `hutch`: 200 samples OR 95% CI within ±1.0."""
	return CountCriterion(count=200) | ConfidenceCriterion(confidence=0.95, atol=1.0, rtol=0.0)


class MeanEstimator:
	"""Sample-mean estimator over a Welford state (``primate_tpu/estimators.py:513-602``):
	a :class:`~primate_tpu_torch.stats.MeanState`, or with ``covariance=True`` a
	:class:`~primate_tpu_torch.stats.CovState`, whose sample variance is
	``converged_variance`` (None without it). ``record=True`` keeps every sample in
	``values`` (a list of floats, in order), which knee criteria read. ``device``, after
	the JAX package's arguments, is where the state lives."""

	def __init__(self, dim: int = 1, covariance: bool = False, record: bool = False, dtype=torch.float64, device="cuda"):
		make_state = make_cov_state if covariance else make_mean_state
		self.state = make_state(dim, dtype, device)
		self.delta = torch.full((dim,), float("inf"), dtype=dtype, device=device)
		self.values: Optional[list] = [] if record else None

	@classmethod
	def from_state(
		cls, state: Union[MeanState, CovState], delta: Optional[torch.Tensor] = None, values=None, n_values: Optional[int] = None
	) -> "MeanEstimator":
		"""An estimator over ``state``, tracking the covariance where ``state`` is a
		:class:`~primate_tpu_torch.stats.CovState`; ``values`` keeps its first ``n_values``
		(default ``state.n``) samples and makes it record."""
		obj = cls.__new__(cls)
		obj.state = state
		obj.delta = torch.full_like(state.mu, float("inf")) if delta is None else delta
		obj.values = None if values is None else list(values)[: int(state.n if n_values is None else n_values)]
		return obj

	@property
	def covariance(self) -> bool:
		return isinstance(self.state, CovState)

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
		if not self.covariance:
			return None
		cov = cov_matrix(self.state, ddof=1).cpu().numpy()
		return float(cov[0, 0]) if self.dim == 1 else cov

	def update(self, x) -> None:
		x = torch.as_tensor(x, dtype=self.state.mu.dtype, device=self.state.mu.device)
		x = torch.atleast_1d(x)
		old_mu = self.state.mu
		self.state = (cov_update if self.covariance else mean_update)(self.state, x[:, None] if x.ndim == 1 else x)
		self.delta = self.state.mu - old_mu
		if self.values is not None:
			self.values.extend(x.reshape(-1).tolist())

	def snapshot(self) -> EstSnapshot:
		values = torch.tensor(self.values, dtype=self.state.mu.dtype) if self.values else None
		return snapshot_of(self.state, self.delta, values)


class ConfidenceEstimator(MeanEstimator):
	"""A mean estimator that carries its CLT confidence interval
	(``primate_tpu/estimators.py:668-720``), on the same Student-t (n < 30) /
	normal quantile ladder as :class:`ConfidenceCriterion`."""

	def __init__(self, confidence: float = 0.95, dim: int = 1, record: bool = False, dtype=torch.float64, device="cuda"):
		if not 0 < confidence < 1:
			raise ValueError("Confidence must be in (0, 1)")
		super().__init__(dim=dim, covariance=True, record=record, dtype=dtype, device=device)
		self.confidence = confidence
		self._z, self._t = clt_quantiles(confidence)

	@property
	def stderr(self) -> float:
		"""Standard error of the running mean (the mean per-output variance at dim > 1)."""
		if self.n_samples < 2:
			return np.inf
		var = float(np.mean(np.diagonal(np.atleast_2d(np.asarray(self.converged_variance)))))
		return float(np.sqrt(max(var, 0.0) / self.n_samples))

	@property
	def margin_of_error(self) -> float:
		n = self.n_samples
		if n < 3:
			return np.inf
		score = self._t[min(max(n - 2, 0), 29)] if n < 30 else self._z
		return float(score * self.stderr)

	@property
	def interval(self) -> tuple:
		"""``(lo, hi)`` confidence interval around :attr:`estimate`."""
		mu, moe = self.estimate, self.margin_of_error
		if self.dim == 1:
			return float(mu) - moe, float(mu) + moe
		return np.asarray(mu) - moe, np.asarray(mu) + moe

	def __repr__(self) -> str:
		if self.n_samples == 0:
			return f"ConfidenceEstimator(confidence={self.confidence}, <empty>)"
		return (
			f"ConfidenceEstimator({arr_summary(np.atleast_1d(np.asarray(self.estimate))[:1])} "
			f"+/- {self.margin_of_error:.4g} @ {self.confidence * 100:.0f}%, #S:{self.n_samples})"
		)


class ControlVariableEstimator(MeanEstimator):
	"""Mean corrected by control variates of known expectation ``ecv``
	(``primate_tpu/estimators.py:593-665``): ``mean(x) − α·(mean(cv) − E[cv])``,
	with α from the running covariance unless given. ``update`` takes rows
	``[x, cv_1, …]``. Host float64 arithmetic, as in the JAX package."""

	def __init__(self, ecv, alpha=None, record: bool = False):
		ecv = np.atleast_1d(ecv).ravel().astype(np.float64)
		if alpha is not None:
			alpha = np.atleast_1d(alpha).ravel()
			if len(alpha) != len(ecv):
				raise ValueError("Coefficients alpha must have same length as the control variables.")
		super().__init__(dim=1, covariance=False, record=record, dtype=torch.float64, device="cpu")
		self.ecv, self.alpha = ecv, alpha
		self._estimate_cor = alpha is None
		self.cov = make_cov_state(len(ecv) + 1, torch.float64, "cpu")
		self.delta = np.inf

	@property
	def n_samples(self) -> int:
		return self.cov.n

	@property
	def estimate(self) -> float:
		if self.cov.n == 0 or self.alpha is None:
			return np.nan
		mu = self.cov.mu.numpy()
		return float(mu[0] - np.dot(np.ravel(self.alpha), mu[1:] - self.ecv))

	def update(self, samples) -> None:
		samples = np.atleast_1d(np.asarray(samples, dtype=np.float64))
		samples = samples[None, :] if samples.ndim == 1 else samples
		old = self.estimate
		self.cov = cov_update(self.cov, torch.from_numpy(samples))
		if self._estimate_cor and self.cov.n > 1:
			C = cov_matrix(self.cov, ddof=1).numpy()
			if C.shape[0] == 2:
				self.alpha = np.atleast_1d(C[0, 1] / C[1, 1])
			else:
				self.alpha = np.linalg.solve(C[1:, 1:], C[1:, 0])
		new = self.estimate
		self.delta = np.inf if (np.isnan(old) or np.isnan(new)) else abs(new - old)
		if self.values is not None:
			self.values.extend(samples[:, 0].tolist())

	def snapshot(self) -> EstSnapshot:
		"""The variance is that of the corrected estimator, ``C00 − C01 C11⁻¹ C10``."""
		var = None
		if self.cov.n > 1:
			C = np.atleast_2d(cov_matrix(self.cov, ddof=1).numpy())
			if np.all(np.isfinite(C)):
				c01 = C[0, 1:]
				try:
					var = float(C[0, 0] - c01 @ np.linalg.solve(C[1:, 1:], c01))
				except np.linalg.LinAlgError:
					var = float(C[0, 0])
				var = max(var, 0.0)
			else:
				var = float(C[0, 0])
		as_t = lambda x: torch.atleast_1d(torch.as_tensor(x, dtype=torch.float32))  # noqa: E731
		return EstSnapshot(
			n=self.cov.n,
			estimate=as_t(self.estimate),
			delta=as_t(self.delta),
			var=None if var is None else torch.tensor(var, dtype=torch.float64),
			values=torch.tensor(self.values, dtype=torch.float64) if self.values else None,
		)


@dataclass
class EstimatorResult:
	"""Result record for the statistical estimators (``primate_tpu/estimators.py:723-736``).
	``samples`` holds a sketch estimator's per-probe estimates; the record unpacks as
	``estimator, criterion, estimate, message, nit, info``."""

	estimator: Optional[MeanEstimator] = None
	criterion: Union[ConvergenceCriterion, str, None] = None
	estimate: Union[float, np.ndarray] = 0.0
	message: str = ""
	nit: int = 0
	info: dict = field(default_factory=dict)
	samples: Optional[np.ndarray] = None

	def __iter__(self) -> Iterator:
		return iter((self.estimator, self.criterion, self.estimate, self.message, self.nit, self.info))
