"""Gauss quadrature from Jacobi matrices.

Counterpart of ``primate_tpu/integrate.py:37-55`` (forward pass; the
Daleckii–Krein derivative is not ported yet).
"""

from typing import Callable

import torch

from .tridiag import eigh_tridiag

__all__ = ["spectral_quad_form"]


def spectral_quad_form(d: torch.Tensor, e: torch.Tensor, fun: Callable) -> torch.Tensor:
	"""``e₁ᵀ f(J(d, e)) e₁ = Σᵢ f(θᵢ) τᵢ`` (Golub-Welsch); ``d (..., k)``, ``e (..., k-1)`` → ``(...,)``."""
	theta, Y = eigh_tridiag(d, e)
	return torch.sum(fun(theta) * Y[..., 0, :] ** 2, dim=-1)
