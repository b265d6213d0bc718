"""Forward three-term recurrence (FTTR) for Gaussian quadrature weights.

Counterpart of ``primate_tpu/fttr.py:22-137`` (Laudadio, Mastronardi & Van
Dooren 2023): the weights of a Gauss rule from its nodes and the Jacobi
coefficients, in O(1) space per node. The recurrence is a Python loop over
the degree, vectorised over every node and batch element at once, in
``promote_types(dtype, float32)``.

The Jacobi coefficients use the reference's leading-slot convention: ``b[i]``
couples ``p_{i-1}`` to ``p_i`` and ``b[0]`` is unused.
"""

from typing import Optional

import numpy as np
import torch

__all__ = ["ortho_poly", "fttr_weights", "fttr"]


def _acc(*tensors) -> torch.dtype:
	dt = tensors[0].dtype
	for t in tensors[1:]:
		dt = torch.promote_types(dt, t.dtype)
	return torch.promote_types(dt, torch.float32)


def ortho_poly(x, mu_sqrt_rec, a, b, z=None, n: Optional[int] = None) -> Optional[torch.Tensor]:
	"""The orthonormal polynomials ``p_0 … p_{n-1}`` at ``x`` → shape ``x.shape + (n,)``.

	``a (n,)``, ``b (n,)`` (leading slot). As in the reference, a numpy array
	``z`` is filled in place and None returned; ``n`` truncates the coefficients.
	"""
	a, b = torch.as_tensor(a), torch.as_tensor(b)
	if n is not None:
		a, b = a[..., :n], b[..., :n]
	if z is not None:
		if not isinstance(z, np.ndarray):
			raise TypeError("`z` must be a preallocated numpy array.")
		z[...] = ortho_poly(x, mu_sqrt_rec, a, b).cpu().numpy().astype(z.dtype)
		return None
	x = torch.as_tensor(x, device=a.device)
	acc = _acc(x, a, b)
	x, a, b = x.to(acc), a.to(acc), b.to(acc)
	z0 = torch.full_like(x, float(mu_sqrt_rec))
	k = a.shape[0]
	if k == 1:
		return z0[..., None]
	zs = [z0, (x - a[0]) * z0 / b[1]]
	for i in range(2, k):
		zs.append((x - a[i - 1]) / b[i] * zs[-1] - b[i - 1] / b[i] * zs[-2])
	return torch.stack(zs, dim=-1)


def fttr_weights(theta, alpha, beta, k: Optional[int] = None) -> torch.Tensor:
	"""Quadrature weights for the nodes ``theta (..., k)`` from Jacobi coefficients
	``alpha (..., n)``, ``beta (..., n)`` (leading slot), in ``theta``'s dtype."""
	theta, alpha, beta = torch.as_tensor(theta), torch.as_tensor(alpha), torch.as_tensor(beta)
	k = theta.shape[-1] if k is None else k
	acc = torch.promote_types(theta.dtype, torch.float32)
	x, a, b = theta.to(acc), alpha.to(acc), beta.to(acc)
	mu_0 = torch.sum(torch.abs(x[..., :k]), dim=-1, keepdim=True)
	z0 = torch.ones_like(x) / torch.sqrt(mu_0)
	sq = z0 * z0
	n = a.shape[-1]
	if n > 1:
		zm2, zm1 = z0, (x - a[..., 0:1]) * z0 / b[..., 1:2]
		sq = sq + zm1 * zm1
		for i in range(2, n):
			s = (x - a[..., i - 1 : i]) / b[..., i : i + 1]
			t = -b[..., i - 1 : i] / b[..., i : i + 1]
			zm2, zm1 = zm1, s * zm1 + t * zm2
			sq = sq + zm1 * zm1
	return ((1.0 / sq) / mu_0).to(theta.dtype)


def fttr(theta, alpha, beta, k: int, weights=None) -> torch.Tensor:
	"""The first ``k`` weights for ``theta``, from the leading ``k × k`` Jacobi matrix.

	With ``weights`` given, returns a copy of it with its first ``k`` entries
	filled (as the JAX package returns its filled copy).
	"""
	theta, alpha, beta = torch.as_tensor(theta), torch.as_tensor(alpha), torch.as_tensor(beta)
	w = fttr_weights(theta[..., :k], alpha[..., :k], beta[..., :k], k=k)
	if weights is None:
		return w
	out = torch.as_tensor(weights).clone()
	out[..., :k] = w
	return out
