"""Streaming Welford mean and covariance on torch tensors.

Counterpart of ``primate_tpu/stats.py:45-103``. The sample count ``n`` is a
host integer: batch sizes are known on the host, so a count-only stopping rule
never reads the device.
"""

from typing import NamedTuple

import torch

__all__ = ["CovState", "make_cov_state", "cov_update", "cov_matrix"]


class CovState(NamedTuple):
	"""Streaming mean + scatter: ``cov = S / (n - ddof)``; ``mu (dim,)``, ``S (dim, dim)``."""

	n: int
	mu: torch.Tensor
	S: torch.Tensor


def make_cov_state(dim: int = 1, dtype=torch.float32, device="cuda") -> CovState:
	return CovState(
		n=0, mu=torch.zeros(dim, dtype=dtype, device=device), S=torch.zeros((dim, dim), dtype=dtype, device=device)
	)


def cov_update(state: CovState, X: torch.Tensor) -> CovState:
	"""Merge a batch ``X (batch, dim)`` into the running mean and scatter (batched Welford)."""
	X = torch.atleast_1d(X)
	X = X[:, None] if X.ndim == 1 else X
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
