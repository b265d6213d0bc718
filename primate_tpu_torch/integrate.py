"""Gaussian quadrature rules from Jacobi (tridiagonal) matrices.

Counterpart of ``primate_tpu/integrate.py:37-231``, with the Daleckii–Krein
derivative of ``spectral_quad_form`` (``:58-84``) as its backward. Every
rule is batched over leading axes: a Lanczos sweep yields nv Jacobi matrices at
once, and one batched ``torch.linalg.eigh`` (Golub-Welsch), one vectorised
recurrence (FTTR) or one batched ``torch.linalg.solve`` (the modified corners of
the Radau and Lobatto rules) serves them all.
"""

from typing import Callable, Optional, Tuple

import torch

from .fttr import fttr_weights
from .linalg import full_f32_matmul
from .tridiag import eigh_tridiag, eigvalsh_tridiag, tridiag_matrix
from .utils.profiling import annotate

__all__ = ["spectral_quad_form", "quadrature", "lanczos_quadrature", "radau_rule", "lobatto_rule", "spectral_density"]


def spectral_density(*args, **kwargs):
	"""Alias of :func:`primate_tpu_torch.density.spectral_density` (``primate_tpu/integrate.py:25-34``)."""
	from .density import spectral_density as _sd

	return _sd(*args, **kwargs)


def values_and_derivatives(fun: Callable, theta: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
	"""``(f(θ), f'(θ))`` by autograd of ``fun`` on a detached ``θ``; a stacked family gives one
	``f'`` per member (``fun`` is elementwise, so each member's gradient of its sum is its ``f'``).
	A ``fun`` whose output carries no gradient (a step) has ``f' = 0``."""
	with torch.enable_grad():
		th = theta.detach().requires_grad_(True)
		ft = fun(th)
		if not ft.requires_grad:
			return ft.detach(), torch.zeros_like(ft)
		members = ft.reshape((-1,) + tuple(theta.shape))
		fp = [torch.autograd.grad(m.sum(), th, retain_graph=True, allow_unused=True)[0] for m in members]
		fp = torch.stack([torch.zeros_like(theta) if g is None else g for g in fp]).reshape(ft.shape)
	return ft.detach(), fp


def divided_differences(theta: torch.Tensor, ft: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
	"""The Daleckii–Krein matrix ``L_ij = f[θᵢ, θⱼ] = (f(θᵢ) − f(θⱼ))/(θᵢ − θⱼ)``, with ``½(f'(θᵢ) + f'(θⱼ))``
	where ``|θᵢ − θⱼ| ≤ 1e-7·max(max|θ|, 1)``, the JAX package's threshold (``primate_tpu/integrate.py:69-73``).
	Batched over ``θ``'s leading axes; a stacked family's ``ft`` and ``fp`` add theirs in front."""
	diff = theta[..., :, None] - theta[..., None, :]
	fdiff = ft[..., :, None] - ft[..., None, :]
	scale = torch.clamp(theta.abs().amax(dim=-1, keepdim=True)[..., None], min=1.0)
	near = diff.abs() <= 1e-7 * scale
	return torch.where(near, 0.5 * (fp[..., :, None] + fp[..., None, :]), fdiff / torch.where(near, 1.0, diff))


_CLOSURE_GRAD = (
	"spectral_quad_form differentiates with respect to d and e only, and fun closes over a tensor that "
	"requires a gradient; as in the JAX package, where fun is a nondiff argument, that gradient is not "
	"defined. Build the parameter into the operator, or evaluate the quadrature under torch.no_grad()."
)


class _SpectralQuadForm(torch.autograd.Function):
	"""``Σᵢ f(θᵢ) y₀ᵢ²`` differentiated by the Daleckii–Krein formula, the transpose of the JAX
	package's JVP (``primate_tpu/integrate.py:58-84``): with ``L`` of :func:`divided_differences` and
	``W = Y (L ∘ y₀y₀ᵀ) Yᵀ``, ``∂d = g·diag(W)`` and ``∂e = g·(W_{k,k+1} + W_{k+1,k})``. No
	``1/(θᵢ − θⱼ)`` survives where Ritz values meet, and a zero-padded node (``y₀ᵢ = 0`` exactly)
	adds 0, whatever its ``f'``. Under autograd, a ``fun`` whose value carries a gradient of its
	own (a closure over a tensor that requires one) is refused: ``fun`` takes no gradient here."""

	@staticmethod
	def forward(ctx, d, e, fun, grad_enabled):
		theta, Y = eigh_tridiag(d, e)
		with torch.set_grad_enabled(grad_enabled):
			ft = fun(theta)
		if ft.requires_grad:
			raise NotImplementedError(_CLOSURE_GRAD)
		ctx.fun, ctx.e_len = fun, e.shape[-1]
		ctx.save_for_backward(theta, Y)
		return torch.sum(ft * Y[..., 0, :] ** 2, dim=-1)

	@staticmethod
	def backward(ctx, g):
		theta, Y = ctx.saved_tensors
		L = divided_differences(theta, *values_and_derivatives(ctx.fun, theta))
		y0 = Y[..., 0, :]
		P = y0[..., :, None] * y0[..., None, :]
		K = torch.where(P == 0, 0.0, g[..., None, None].to(L.dtype) * L * P).to(Y.dtype)
		K = K.sum_to_size(Y.shape)  # a stacked family's members add up
		with full_f32_matmul():
			W = Y @ K @ Y.mT
		dd = torch.diagonal(W, dim1=-2, dim2=-1)
		de = torch.diagonal(W, offset=1, dim1=-2, dim2=-1) + torch.diagonal(W, offset=-1, dim1=-2, dim2=-1)
		if ctx.e_len == theta.shape[-1]:  # a length-k e with its leading entry unused
			de = torch.cat([torch.zeros_like(de[..., :1]), de], dim=-1)
		return dd, de, None, None


def spectral_quad_form(d: torch.Tensor, e: torch.Tensor, fun: Callable) -> torch.Tensor:
	"""``e₁ᵀ f(J(d, e)) e₁ = Σᵢ f(θᵢ) τᵢ`` (Golub-Welsch); ``d (..., k)``, ``e (..., k-1)`` → ``(...,)``.
	A stacked ``fun`` (:func:`~primate_tpu_torch.special.stacked`) adds its leading axis.

	The derivative with respect to ``d`` and ``e`` is the Daleckii–Krein formula
	(:class:`_SpectralQuadForm`), finite where Ritz values meet. ``fun`` takes no gradient: under
	autograd, a ``fun`` that closes over a tensor requiring a gradient raises ``NotImplementedError``."""
	with annotate("primate.quadrature"):
		return _SpectralQuadForm.apply(d, e, fun, torch.is_grad_enabled())


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
	with annotate("primate.quadrature"):
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
