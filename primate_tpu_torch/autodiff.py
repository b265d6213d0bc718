r"""Differentiable spectral sums: autograd through stochastic trace estimates.

Counterpart of ``primate_tpu/autodiff.py``. The fixed-budget SLQ estimate of
``tr f(A)`` is a ``torch.autograd.Function`` whose backward uses

    ∂ tr f(A) = tr(f'(A) ∂A),   estimated by   (1/m) Σᵢ wᵢᵀ (∂A) zᵢ,   wᵢ = f'(A) zᵢ,

with the probes ``zᵢ`` shared by the forward estimate and the gradient, instead of
differentiating through the Lanczos recurrence. For ``f = log`` and ``f = inv``,
``f'(A)zᵢ`` comes from batched CG (:func:`~primate_tpu_torch.solvers.cg`); for any
other function ``f'`` comes from autograd and a second ``MatrixFunction`` sweep.
The cotangent reaches the operator's tensors
(:meth:`~primate_tpu_torch.operators.base.LinearOperator.float_tensors`: DIA
bands, BSR tiles, CSR values, a dense matrix, and the tensors they were computed
from) by ``torch.autograd.grad`` of the operator's own ``matmat``, whose applies
are the kernels' autograd Functions (:mod:`~primate_tpu_torch.ops.autograd`).

The probes come in chunks: chunk ``i`` is drawn from the generator keyed
``(seed, i)`` (:func:`~primate_tpu_torch.trace.batch_generator`) in the forward pass
and drawn again in the backward pass, so no ``(n, nv)`` block is kept between the
two and peak memory is O(n · chunk).

The returned gradient is an unbiased stochastic estimate of ∇ tr f(A), not the
exact derivative of the stochastic forward value (GPyTorch's convention); resample
probes across optimisation steps (a seed per step).
"""

from typing import Callable, Optional, Union

import torch

from .operators.base import aslinop
from .operators.special_ops import MatrixFunction
from .random import real_dtype, sample_isotropic
from .special import _log_eps

__all__ = ["spectral_sum", "spectral_sum_core", "logdet", "trace_inv"]


def _elementwise_grad(f: Callable) -> Callable:
	"""Derivative of an elementwise spectral function by autograd of ``sum(f(x))``."""

	def fprime(x):
		x = torch.as_tensor(x)
		x = x.detach().to(torch.promote_types(x.dtype, torch.float32)).requires_grad_(True)
		with torch.enable_grad():
			(g,) = torch.autograd.grad(torch.sum(f(x)), x)
		return g

	return fprime


def _is_log(fun: Callable) -> bool:
	# `_log_eps` is what `MatrixFunction(..., fun="log")` resolves to.
	return fun is _log_eps or fun is torch.log


def _is_inv(fun: Callable) -> bool:
	return fun is torch.reciprocal


def _check_grad_supported(M, gbar: torch.Tensor) -> None:
	if M.dtype.is_complex:
		raise NotImplementedError(
			"spectral_sum gradients are real-symmetric only; for Hermitian operators "
			"differentiate through the real embedding [[Re, -Im], [Im, Re]]."
		)
	if gbar.ndim != 0:
		raise NotImplementedError(
			"spectral_sum gradients need a scalar spectral function; stacked families "
			"(special.stacked) are forward-only — estimate each member separately to differentiate."
		)


def _apply_fprime(M, Zc: torch.Tensor, fprime, grad_method: str, solver_rtol: float, solver_maxiter) -> torch.Tensor:
	"""``W = f'(A) Z``: CG for log and inv, a second Lanczos sweep otherwise (``primate_tpu/autodiff.py:127-157``)."""
	A, fun = M.operator, M.fun
	method = grad_method
	if method == "auto":
		method = "cg" if (_is_log(fun) or _is_inv(fun)) and fprime is None else "slq"
	if method == "cg":
		from .solvers import cg

		if not (_is_log(fun) or _is_inv(fun)):
			raise ValueError(
				"grad_method='cg' applies only to fun='log' (f' = A⁻¹) or fun='inv' "
				"(f' = -A⁻²); pass fprime= or grad_method='slq' for other functions."
			)
		W = cg(A, Zc, rtol=solver_rtol, maxiter=solver_maxiter)
		if _is_inv(fun):
			W = -cg(A, W, rtol=solver_rtol, maxiter=solver_maxiter)
		return W
	fp = fprime if fprime is not None else _elementwise_grad(fun)
	Mp = MatrixFunction(
		A, fun=fp, deg=M.degree, orth=M._orth, dtype=M.dtype, two_pass=M._two_pass,
		reorth_passes=M._reorth_passes, basis_dtype=M._basis_dtype,
	)
	return Mp._matmat(Zc)


class _SpectralSum(torch.autograd.Function):
	"""Mean over ``nchunks`` probe chunks of ``mean(M.quad(Z_i))``, differentiable in the
	operator's tensors (``primate_tpu/autodiff.py:74-111,160-224``)."""

	@staticmethod
	def forward(ctx, M, draw, nchunks, grad_cfg, *tensors):
		ctx.M, ctx.draw, ctx.nchunks, ctx.grad_cfg = M, draw, nchunks, grad_cfg
		ctx.save_for_backward(*tensors)
		vals = [torch.mean(M.quad(draw(i)), dim=-1) for i in range(nchunks)]
		return torch.mean(torch.stack(vals), dim=0)

	@staticmethod
	def backward(ctx, gbar):
		M, draw, nchunks = ctx.M, ctx.draw, ctx.nchunks
		_check_grad_supported(M, gbar)
		tensors = ctx.saved_tensors
		want = [i for i, need in enumerate(ctx.needs_input_grad[4:]) if need]
		grads = [None] * len(tensors)
		for i in range(nchunks):
			Zc = draw(i).to(M.dtype)
			W = _apply_fprime(M, Zc, *ctx.grad_cfg)
			coef = gbar / (nchunks * Zc.shape[-1])
			# (gbar/m) Σᵢ wᵢᵀ (∂A) zᵢ, pulled back through the operator's own matmat.
			with torch.enable_grad():
				out = M.operator.matmat(Zc)
				got = torch.autograd.grad(out, [tensors[j] for j in want], coef * W.to(M.dtype), allow_unused=True)
			for j, g in zip(want, got):
				if g is not None:
					grads[j] = g if grads[j] is None else grads[j] + g
			del Zc, W, out, got
		return (None, None, None, None, *grads)


def spectral_sum_core(
	M: MatrixFunction,
	draw: Callable[[int], torch.Tensor],
	nchunks: int = 1,
	fprime: Optional[Callable] = None,
	grad_method: str = "auto",
	solver_rtol: float = 1e-6,
	solver_maxiter: Optional[int] = None,
) -> torch.Tensor:
	"""The differentiable estimate on a probe sampler: ``draw(i)`` returns chunk ``i``'s
	``(n, chunk)`` probes, the same block each time it is called for ``i``."""
	return _SpectralSum.apply(M, draw, int(nchunks), (fprime, grad_method, float(solver_rtol), solver_maxiter), *M.float_tensors())


def spectral_sum(
	A,
	fun: Union[str, Callable, None] = None,
	deg: int = 20,
	orth: int = 3,
	nv: int = 64,
	pdf: str = "rademacher",
	seed=None,
	fprime: Optional[Callable] = None,
	grad_method: str = "auto",
	solver_rtol: float = 1e-6,
	solver_maxiter: Optional[int] = None,
	dtype=None,
	chunk: Optional[int] = None,
	device="cuda",
	**fun_kwargs,
) -> torch.Tensor:
	r"""Differentiable stochastic estimate of ``tr(f(A))`` on a fixed probe budget
	(``primate_tpu/autodiff.py:227-292``).

	Forward: stochastic Lanczos quadrature on ``nv`` shared probes; backward: the
	``tr(f'(A)·∂A)`` identity, no differentiation through the recurrence.

	Parameters:
		A: operator or matrix (anything :func:`aslinop` takes; a numpy or scipy one goes
			to ``device``), or a :class:`MatrixFunction` (its ``fun``/``deg``/``orth`` are used).
		fun: spectral function name or callable on tensors.
		deg, orth: Lanczos degree and re-orthogonalisation window.
		nv: probe count; pdf: "rademacher", "normal" or "sphere"; seed: an int, a numpy
			Generator or None.
		fprime: the derivative of ``fun`` (else autograd's).
		grad_method: "auto" (CG for log and inv, else SLQ), "cg" or "slq".
		solver_rtol, solver_maxiter: the CG controls of the gradient solves.
		chunk: probes per block; the budget rounds up to whole chunks, peak memory
			O(n·chunk) in both passes. Chunk ``i`` comes from the generator keyed
			``(seed, i)``; without ``chunk`` the whole budget is chunk 0.

	Returns a 0-d tensor on the operator's device (``(nt,)`` for a stacked family,
	forward only), with a gradient to the operator's tensors.
	"""
	from .trace import _base_seed, batch_generator

	if isinstance(A, MatrixFunction):
		M = A
	else:
		M = MatrixFunction(aslinop(A, dtype=dtype, device=device), fun=fun, deg=deg, orth=orth, dtype=dtype, **fun_kwargs)
	nv = int(nv)
	chunk = int(chunk) if chunk is not None and int(chunk) < nv else nv
	nchunks = -(-nv // chunk)
	base, n = _base_seed(seed), M.shape[0]

	def draw(i: int) -> torch.Tensor:
		return sample_isotropic(batch_generator(base, i, M.device), (n, chunk), pdf=pdf, dtype=real_dtype(M.dtype))

	return spectral_sum_core(M, draw, nchunks, fprime, grad_method, solver_rtol, solver_maxiter)


def logdet(
	A, deg: int = 20, orth: int = 5, nv: int = 64, seed=None, solver_rtol: float = 1e-6,
	solver_maxiter: Optional[int] = None, **kwargs,
) -> torch.Tensor:
	r"""Differentiable ``log det(A)`` for SPD ``A``: SLQ forward, ``∂ logdet(A) = tr(A⁻¹ ∂A)``
	by batched CG on the forward's probes (``primate_tpu/autodiff.py:295-316``)."""
	return spectral_sum(A, "log", deg=deg, orth=orth, nv=nv, seed=seed, solver_rtol=solver_rtol, solver_maxiter=solver_maxiter, **kwargs)


def trace_inv(
	A, deg: int = 20, orth: int = 5, nv: int = 64, seed=None, solver_rtol: float = 1e-6,
	solver_maxiter: Optional[int] = None, **kwargs,
) -> torch.Tensor:
	r"""Differentiable ``tr(A⁻¹)``: SLQ forward, ``∂ tr(A⁻¹) = −tr(A⁻²∂A)`` by two chained CG
	solves per probe block (``primate_tpu/autodiff.py:319-334``)."""
	return spectral_sum(A, "inv", deg=deg, orth=orth, nv=nv, seed=seed, solver_rtol=solver_rtol, solver_maxiter=solver_maxiter, **kwargs)
