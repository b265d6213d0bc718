"""Streaming Welford mean and covariance on torch tensors.

Counterpart of ``primate_tpu/stats.py``. ``MeanState``/``CovState`` and their pure
updates are what the estimators carry; ``Mean`` and ``Covariance`` are the host-facing
classes around them, and ``confidence_interval`` the interval of a sample mean. The
sample count ``n`` is a host integer: batch sizes are known on the host, so a count-only
stopping rule never reads the device. The classes keep their state on ``device`` (the
card unless the caller passes ``"cpu"``) and read the host only where the JAX package
returns a Python number: ``mean()`` and ``covariance()`` of a one-dimensional stream.
"""

from typing import NamedTuple, Union

import numpy as np
import torch

__all__ = [
	"MeanState",
	"CovState",
	"make_mean_state",
	"make_cov_state",
	"mean_update",
	"cov_update",
	"cov_matrix",
	"Mean",
	"Covariance",
	"confidence_interval",
]


class MeanState(NamedTuple):
	"""Streaming mean: ``n`` samples seen, running mean ``mu (dim,)``."""

	n: int
	mu: torch.Tensor


class CovState(NamedTuple):
	"""Streaming mean + scatter: ``cov = S / (n - ddof)``; ``mu (dim,)``, ``S (dim, dim)``."""

	n: int
	mu: torch.Tensor
	S: torch.Tensor


def make_mean_state(dim: int = 1, dtype=torch.float32, device="cuda") -> MeanState:
	return MeanState(n=0, mu=torch.zeros(dim, dtype=dtype, device=device))


def make_cov_state(dim: int = 1, dtype=torch.float32, device="cuda") -> CovState:
	return CovState(
		n=0, mu=torch.zeros(dim, dtype=dtype, device=device), S=torch.zeros((dim, dim), dtype=dtype, device=device)
	)


def _as_batch(X: torch.Tensor) -> torch.Tensor:
	"""Samples as ``(batch, dim)``: a 0-d tensor becomes ``(1, 1)``, ``(n,)`` becomes ``(n, 1)``."""
	X = torch.atleast_1d(X)
	return X[:, None] if X.ndim == 1 else X


def mean_update(state: MeanState, X: torch.Tensor) -> MeanState:
	"""Merge a batch ``X (batch, dim)`` into the running mean."""
	X = _as_batch(torch.as_tensor(X, device=state.mu.device))
	b = X.shape[0]
	new_n = state.n + b
	return MeanState(n=new_n, mu=state.mu + (b / new_n) * (torch.mean(X, dim=0) - state.mu))


def cov_update(state: CovState, X: torch.Tensor) -> CovState:
	"""Merge a batch ``X (batch, dim)`` into the running mean and scatter (batched Welford)."""
	X = _as_batch(X)
	b = X.shape[0]
	batch_mean = torch.mean(X, dim=0)
	delta = batch_mean - state.mu
	new_n = state.n + b
	mu = state.mu + (b / new_n) * delta
	Xc = X - batch_mean[None, :]
	# Outer products as broadcast sums, not matmuls: no TF32 path on the card.
	shift = (delta.conj()[:, None] * delta[None, :]) * (state.n * b / new_n)
	S = state.S + torch.sum(Xc.conj()[:, :, None] * Xc[:, None, :], dim=0) + shift
	return CovState(n=new_n, mu=mu, S=S)


def cov_matrix(state: CovState, ddof: int = 1) -> torch.Tensor:
	"""Covariance estimate ``S / (n - ddof)``; +inf while underdetermined."""
	denom = state.n - ddof
	if denom <= 0:
		return torch.full_like(state.S, float("inf"))
	return state.S / denom


class Mean:
	"""Streaming mean of ``dim``-dimensional samples (wraps :class:`MeanState`).

	``dtype`` defaults to torch's default float dtype. A batch of a wider dtype widens
	the state; a narrower one never narrows it.
	"""

	def __init__(self, dim: int = 1, dtype=None, device="cuda"):
		self.dim = dim
		self._state = make_mean_state(dim, dtype or torch.get_default_dtype(), device)

	@property
	def n(self) -> int:
		return self._state.n

	@property
	def mu(self) -> torch.Tensor:
		return self._state.mu

	def _batch(self, X) -> torch.Tensor:
		X = _as_batch(torch.as_tensor(X, device=self.mu.device))
		if X.shape[1] != self.dim:
			raise ValueError(f"Expected shape (n, {self.dim}), got {tuple(X.shape)}")
		return X

	def _widen(self, X: torch.Tensor) -> torch.Tensor:
		"""``X`` in the state's dtype, after widening the state to ``X``'s where that is wider."""
		wide = torch.promote_types(self.mu.dtype, X.dtype)
		if wide != self.mu.dtype:
			self._state = type(self._state)(self._state.n, *(t.to(wide) for t in self._state[1:]))
		return X.to(wide)

	def update(self, X) -> None:
		self._state = mean_update(self._state, self._widen(self._batch(X)))

	def mean(self) -> Union[float, torch.Tensor]:
		if self.n == 0:
			return np.nan
		return self.mu.item() if self.dim == 1 else self.mu

	__call__ = mean


class Covariance(Mean):
	"""Streaming covariance of ``dim``-dimensional samples (wraps :class:`CovState`), Welford-stable."""

	def __init__(self, dim: int = 1, dtype=None, device="cuda"):
		self.dim = dim
		self._state = make_cov_state(dim, dtype or torch.get_default_dtype(), device)

	@property
	def S(self) -> torch.Tensor:
		return self._state.S

	def update(self, X) -> None:
		self._state = cov_update(self._state, self._widen(self._batch(X)))

	def covariance(self, ddof: int = 1) -> Union[float, torch.Tensor]:
		cov = cov_matrix(self._state, ddof=ddof)
		return cov.item() if self.dim == 1 else cov

	def __call__(self, ddof: int = 1) -> Union[float, torch.Tensor]:
		return self.covariance(ddof=ddof)


def confidence_interval(a, confidence: float = 0.95, sdist: str = "t") -> tuple:
	"""Confidence interval ``(lo, hi)`` for the mean of the measurements ``a``, on the host
	(``primate_tpu/stats.py:185-205``): Student-t by default, the normal approximation
	with ``sdist="normal"``."""
	import scipy.stats as st

	a = (a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)).ravel()
	if not 0.0 <= confidence <= 1.0:
		raise ValueError("Invalid confidence measure")
	mean = float(np.mean(a))
	if sdist == "t":
		sem = st.sem(a, ddof=1)
		m = st.t.ppf((1 + confidence) / 2.0, len(a) - 1)
		return mean - m * sem, mean + m * sem
	if sdist == "normal":
		scale = np.std(a, ddof=1) / np.sqrt(len(a))
		return st.norm.interval(confidence, loc=mean, scale=scale)
	raise ValueError(f"Unknown sampling distribution '{sdist}'.")


def __getattr__(name):
	# The JAX package's stats also names the two estimators kept in ``estimators``.
	if name in ("ConfidenceEstimator", "ControlVariableEstimator"):
		from . import estimators

		return getattr(estimators, name)
	raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
