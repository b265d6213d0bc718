"""The path graph's Laplacian plus a shift: ``tridiag(o, d, o)``, here ``tridiag(−1, 3, −1)``.

Eigenvalues ``d + 2o·cos(kπ/(n+1))``, ``k = 1..n``, so ``log det`` has a closed form.
"""

import numpy as np
import torch


def size(params: dict) -> int:
	return int(params["n"])


def apply(params: dict, X: torch.Tensor, rnd=lambda x: x) -> torch.Tensor:
	"""``A X`` on a probe-major ``(nv, n)`` block."""
	d, o = float(params["diagonal"]), float(params["off_diagonal"])
	Y = X * d
	Y[:, :-1].add_(X[:, 1:], alpha=o)
	Y[:, 1:].add_(X[:, :-1], alpha=o)
	return Y


def interval(params: dict) -> tuple:
	d, o = float(params["diagonal"]), abs(float(params["off_diagonal"]))
	return d - 2.0 * o, d + 2.0 * o


def eigenvalues(params: dict) -> np.ndarray:
	n, d, o = size(params), float(params["diagonal"]), float(params["off_diagonal"])
	return d + 2.0 * o * np.cos(np.arange(1, n + 1) * np.pi / (n + 1))


def logdet(params: dict) -> float:
	return float(np.sum(np.log(eigenvalues(params))))
