"""Gaussian quadrature rules from Jacobi (tridiagonal) matrices.

Counterpart of ``primate_tpu/integrate.py:37-231`` (the forward pass; the
Daleckii–Krein derivative of ``spectral_quad_form`` is not ported yet). Every
rule is batched over leading axes: a Lanczos sweep yields nv Jacobi matrices at
once, and one batched ``torch.linalg.eigh`` (Golub-Welsch), one vectorised
recurrence (FTTR) or one batched ``torch.linalg.solve`` (the modified corners of
the Radau and Lobatto rules) serves them all.
"""

from typing import Callable, Optional, Tuple

import torch

from .fttr import fttr_weights
from .tridiag import eigh_tridiag, eigvalsh_tridiag, tridiag_matrix

__all__ = ["spectral_quad_form", "quadrature", "lanczos_quadrature", "radau_rule", "lobatto_rule", "spectral_density"]


def spectral_density(*args, **kwargs):
	"""Alias of :func:`primate_tpu_torch.density.spectral_density` (``primate_tpu/integrate.py:25-34``)."""
	from .density import spectral_density as _sd

	return _sd(*args, **kwargs)


def spectral_quad_form(d: torch.Tensor, e: torch.Tensor, fun: Callable) -> torch.Tensor:
	"""``e₁ᵀ f(J(d, e)) e₁ = Σᵢ f(θᵢ) τᵢ`` (Golub-Welsch); ``d (..., k)``, ``e (..., k-1)`` → ``(...,)``.
	A stacked ``fun`` (:func:`~primate_tpu_torch.special.stacked`) adds its leading axis."""
	theta, Y = eigh_tridiag(d, e)
	return torch.sum(fun(theta) * Y[..., 0, :] ** 2, dim=-1)


def _solve_shifted(d: torch.Tensor, e: torch.Tensor, rhs_last: torch.Tensor, shift) -> torch.Tensor:
	"""The last entry of ``x`` solving ``(J(d, e) − shift·I) x = rhs_last·e_k``, batched.

	A singular shift (a deflated probe's zero-padded Jacobi matrix has exact zero
	eigenvalues) gives 0 where the LU solve's last entry is not finite, as in the
	JAX package.
	"""
	J = tridiag_matrix(d, e)
	k = d.shape[-1]
	A = J - shift * torch.eye(k, dtype=J.dtype, device=J.device)
	rhs = torch.zeros(d.shape[:-1] + (k, 1), dtype=J.dtype, device=J.device)
	rhs[..., -1, 0] = rhs_last
	x_k = torch.linalg.solve_ex(A, rhs).result[..., -1, 0]
	return torch.where(torch.isfinite(x_k), x_k, torch.zeros_like(x_k))


def radau_rule(d: torch.Tensor, e: torch.Tensor, beta_end: torch.Tensor, x0) -> Tuple[torch.Tensor, torch.Tensor]:
	r"""Gauss–Radau rule with one node fixed at ``x0`` (Golub 1973; ``primate_tpu/integrate.py:110-137``).

	From the Jacobi matrix ``J_k(d, e)`` and the next coupling ``beta_end = β_k``,
	the (k+1)-point rule of the extended matrix with corner ``x0 + δ_k``,
	``(J_k − x0·I) δ = β_k² e_k``. ``d (..., k)``, ``e (..., k-1)``,
	``beta_end (...,)``; returns ``(nodes, weights)``, each ``(..., k+1)``.
	"""
	x0 = torch.as_tensor(x0, dtype=d.dtype, device=d.device)
	delta_k = _solve_shifted(d, e, beta_end**2, x0)
	d_ext = torch.cat([d, (x0 + delta_k)[..., None]], dim=-1)
	e_ext = torch.cat([e, beta_end[..., None].to(e.dtype)], dim=-1)
	theta, Y = eigh_tridiag(d_ext, e_ext)
	return theta, Y[..., 0, :] ** 2


def lobatto_rule(d: torch.Tensor, e: torch.Tensor, beta_end, x0, x1) -> Tuple[torch.Tensor, torch.Tensor]:
	r"""Gauss–Lobatto rule with nodes fixed at both ``x0 < x1`` (``primate_tpu/integrate.py:140-170``).

	The extended corner and coupling solve ``(J_k − x0·I) δ = e_k``,
	``(J_k − x1·I) μ = e_k``: ``d̂ = (x1·δ_k − x0·μ_k)/(δ_k − μ_k)``,
	``β̂² = (x1 − x0)/(δ_k − μ_k)``. ``beta_end`` is unused (the coupling is
	derived), kept for the signature of :func:`radau_rule`.
	"""
	del beta_end
	x0 = torch.as_tensor(x0, dtype=d.dtype, device=d.device)
	x1 = torch.as_tensor(x1, dtype=d.dtype, device=d.device)
	ones = torch.ones(d.shape[:-1], dtype=d.dtype, device=d.device)
	delta_k = _solve_shifted(d, e, ones, x0)
	mu_k = _solve_shifted(d, e, ones, x1)
	denom = delta_k - mu_k
	safe = torch.where(denom == 0, torch.ones_like(denom), denom)
	d_hat = (x1 * delta_k - x0 * mu_k) / safe
	beta2 = (x1 - x0) / safe
	d_ext = torch.cat([d, d_hat[..., None]], dim=-1)
	e_ext = torch.cat([e, torch.sqrt(torch.clamp(beta2, min=0.0))[..., None]], dim=-1)
	theta, Y = eigh_tridiag(d_ext, e_ext)
	return theta, Y[..., 0, :] ** 2


def quadrature(
	d,
	e,
	deg: Optional[int] = None,
	quad: str = "gw",
	nodes=None,
	weights=None,
	method: str = "auto",
	maxiter: int = 30,
) -> Tuple[torch.Tensor, torch.Tensor]:
	r"""Degree-``deg`` Gaussian quadrature rule of the Jacobi matrix ``J(d, e)``
	(``primate_tpu/integrate.py:173-225``).

	Nodes are the eigenvalues of the leading ``deg × deg`` block; weights the
	squared first eigenvector components (``quad="gw"``, Golub-Welsch) or the
	forward three-term recurrence (``quad="fttr"``). ``d (..., n)`` and ``e``
	(length n with a leading zero, or n-1) may carry batch axes; ``method`` and
	``maxiter`` go to the tridiagonal eigensolver. With both ``nodes`` and
	``weights`` given, copies of them with the first ``deg`` entries filled are
	returned, as the JAX package returns its filled copies.
	"""
	d, e = torch.as_tensor(d), torch.as_tensor(e)
	n = d.shape[-1]
	deg = n if deg is None else int(min(deg, n))
	if e.shape[-1] == n - 1:
		e = torch.cat([torch.zeros(e.shape[:-1] + (1,), dtype=e.dtype, device=e.device), e], dim=-1)
	if e.shape[-1] != n:
		raise ValueError("Subdiagonal must have length n or n-1")
	if quad in ("gw", "golub_welsch"):
		theta, ev = eigh_tridiag(d[..., :deg], e[..., :deg], method=method, maxiter=maxiter)
		tau = ev[..., 0, :] ** 2
	elif quad == "fttr":
		theta = eigvalsh_tridiag(d[..., :deg], e[..., :deg], method=method, maxiter=maxiter)
		tau = fttr_weights(theta, d[..., :deg], e[..., :deg], k=deg)
	else:
		raise ValueError(f"Invalid quadrature method '{quad}' supplied")
	if nodes is not None and weights is not None:
		k = theta.shape[-1]
		nodes, weights = torch.as_tensor(nodes).clone(), torch.as_tensor(weights).clone()
		nodes[..., :k] = theta
		weights[..., :k] = tau
		return nodes, weights
	return theta, tau


lanczos_quadrature = quadrature
