"""Block Lanczos: one Krylov space of a probe block, its block-tridiagonal factor, block quadrature.

Counterpart of ``primate_tpu/block_krylov.py``. Where :func:`~primate_tpu_torch.lanczos`
runs nv independent three-term recurrences, block Lanczos couples a block
``V (n, b)`` into one space ``span{V, AV, …, A^{deg-1}V}``:

	A Q = Q T + residual,    T block-tridiagonal with b×b blocks Aⱼ (Hermitian), Bⱼ (upper-triangular)

which holds eigenvalues of multiplicity up to ``b`` and gives the matrix-valued Gauss
rule ``Vᵀ f(A) V ≈ R₀ᵀ [f(T)]₁₁ R₀`` (Golub-Meurant). The blocks are carried
node-major ``(n, b)`` and applied by ``op.matmat`` (on a DIA operator the node-major
stencil ``dia_stencil``); each step is two thin GEMMs, two CGS passes against the
stored ``(n, deg·b)`` basis (two GEMMs each) and one thin QR, all under
:func:`~primate_tpu_torch.linalg.full_f32_matmul` (the identities are exact algebra;
TF32 would break them). The loop enqueues device work and never reads the device.
"""

from typing import Callable, NamedTuple, Optional, Union

import torch

from .integrate import divided_differences, values_and_derivatives
from .linalg import full_f32_matmul
from .operators.base import aslinop
from .random import real_dtype, sample_isotropic
from .special import param_callable

__all__ = ["BlockLanczosOutput", "block_lanczos", "block_jacobi_dense", "block_quadrature", "block_slq_trace"]


class BlockLanczosOutput(NamedTuple):
	"""Ablocks ``(deg, b, b)``: the Hermitian diagonal blocks. Bblocks ``(deg, b, b)``: the
	sub-diagonal blocks, ``Bblocks[j]`` coupling step j to j+1 (the last the residual factor).
	R0 ``(b, b)``: the upper-triangular factor of ``V0 = Q₁R₀``. basis ``(deg, n, b)`` or None."""

	Ablocks: torch.Tensor
	Bblocks: torch.Tensor
	R0: torch.Tensor
	basis: Optional[torch.Tensor] = None


def _h(X: torch.Tensor) -> torch.Tensor:
	return X.mH if X.is_complex() else X.T


def _qr_pos(W: torch.Tensor):
	"""Thin QR with a nonnegative real diagonal of R, so the factor is deterministic: a sign
	flip per column, a unit phase ``p = d/|d|`` for complex ``W`` (``Q·diag(p)``, ``diag(p̄)·R``).
	Q comes back node-major (row-major), the layout the node-major kernels read."""
	with full_f32_matmul():
		Q, R = torch.linalg.qr(W, mode="reduced")
	d = torch.diagonal(R)
	if W.is_complex():
		mag = torch.abs(d)
		p = torch.where(mag > 0, d / torch.where(mag > 0, mag, 1.0), torch.ones_like(d))
	else:
		p = torch.where(d < 0, -1.0, 1.0).to(W.dtype)
	return (Q * p[None, :]).contiguous(), R * torch.conj(p)[:, None]


def _block_lanczos_core(op, V0: torch.Tensor, deg: int, reorth: bool = True, return_basis: bool = False) -> BlockLanczosOutput:
	"""``deg`` block Lanczos steps from ``V0 (n, b)`` (``primate_tpu/block_krylov.py:87-143``).
	A complex (Hermitian) operator runs in its complex dtype (``V0`` may be real)."""
	n, b = V0.shape
	acc = torch.promote_types(V0.dtype, torch.float32)
	if op.dtype.is_complex:
		acc = torch.promote_types(acc, op.dtype)
	Q1, R0 = _qr_pos(V0.to(acc))
	keep_basis = reorth or return_basis
	# The basis as one node-major (n, deg·b) matrix, block j in columns [jb, (j+1)b): each CGS
	# pass is two GEMMs over it. The blocks past j are zero, so they project to zero.
	basis = torch.zeros((n, deg * b), dtype=acc, device=V0.device) if keep_basis else None
	if keep_basis:
		basis[:, :b] = Q1
	Ab = torch.empty((deg, b, b), dtype=acc, device=V0.device)
	Bb = torch.empty((deg, b, b), dtype=acc, device=V0.device)
	V_prev, V_cur, B_prev = torch.zeros_like(Q1), Q1, torch.zeros((b, b), dtype=acc, device=V0.device)
	for j in range(deg):
		W = op.matmat(V_cur).to(acc)
		with full_f32_matmul():
			Aj = _h(V_cur) @ W
			Aj = 0.5 * (Aj + _h(Aj))
			W = W - V_cur @ Aj - V_prev @ _h(B_prev)
			if reorth:
				for _ in range(2):
					W = W - basis @ (_h(basis) @ W)
		V_next, B_next = _qr_pos(W)
		if keep_basis and j + 1 < deg:
			if V_next.requires_grad:  # out of place: the CGS passes above saved this basis for the backward
				basis = torch.cat([basis[:, : (j + 1) * b], V_next, basis[:, (j + 2) * b :]], dim=1)
			else:
				basis[:, (j + 1) * b : (j + 2) * b] = V_next
		Ab[j], Bb[j] = Aj, B_next
		V_prev, V_cur, B_prev = V_cur, V_next, B_next
	return BlockLanczosOutput(Ab, Bb, R0, basis.reshape(n, deg, b).permute(1, 0, 2) if return_basis else None)


def block_lanczos(
	A, V0=None, deg: Optional[int] = None, b: int = 4, reorth: bool = True, return_basis: bool = False,
	pdf: str = "normal", seed=None, device="cuda",
) -> BlockLanczosOutput:
	"""Block Lanczos factorisation of a symmetric or Hermitian operator
	(``primate_tpu/block_krylov.py:146-174``). ``b`` is the block width (ignored with ``V0``);
	``deg`` counts block steps (the space has dimension ``deg·b``, clamped to n). Without
	``V0`` the block is drawn from ``seed`` with ``pdf``. ``device``: where a numpy or
	scipy ``A`` goes."""
	from .trace import _base_seed, batch_generator

	op = aslinop(A, device=device)
	n = op.shape[0]
	if V0 is None:
		b = min(int(b), n)  # a block wider than the space has dependent columns
		g = batch_generator(_base_seed(seed), 0, op.device)
		V0 = sample_isotropic(g, (n, b), pdf=pdf, dtype=real_dtype(torch.promote_types(op.dtype, torch.float32)))
	V0 = torch.as_tensor(V0, device=op.device)
	if V0.ndim != 2 or V0.shape[0] != n:
		raise ValueError(f"V0 must be (n, b) with n={n}; got {tuple(V0.shape)}")
	if V0.shape[1] > n:
		raise ValueError(f"Block width b={V0.shape[1]} exceeds the operator dimension n={n}")
	b = V0.shape[1]
	deg = int(max(1, min(n // b if deg is None else deg, n // max(b, 1))))
	return _block_lanczos_core(op, V0, deg=deg, reorth=reorth, return_basis=return_basis)


def block_jacobi_dense(Ablocks: torch.Tensor, Bblocks: torch.Tensor) -> torch.Tensor:
	"""The ``(deg·b, deg·b)`` block-tridiagonal T; ``Bblocks[deg-1]`` (the residual factor) is left out."""
	deg, b, _ = Ablocks.shape
	T = torch.zeros((deg * b, deg * b), dtype=Ablocks.dtype, device=Ablocks.device)
	for j in range(deg):
		T[j * b : (j + 1) * b, j * b : (j + 1) * b] = Ablocks[j]
		if j + 1 < deg:
			T[(j + 1) * b : (j + 2) * b, j * b : (j + 1) * b] = Bblocks[j]
			T[j * b : (j + 1) * b, (j + 1) * b : (j + 2) * b] = _h(Bblocks[j])
	return T


class _HermitianFunction(torch.autograd.Function):
	"""``f(T) = Y f(θ) Yᴴ`` of a Hermitian ``T = Y diag(θ) Yᴴ``, differentiated by the Daleckii-Krein
	formula ``grad_T = Y (K ∘ (Yᴴ G Y)) Yᴴ``, ``K_ij = (f(θ_i) − f(θ_j))/(θ_i − θ_j)`` (the mean of ``f'``
	where two eigenvalues meet, :func:`~primate_tpu_torch.integrate.divided_differences`). It is the gradient of ``eigh``'s backward for a loss that depends on the
	eigenvectors only through ``f(T)``, but reads no eigenvector phase: PyTorch's ``eigh`` backward
	refuses a complex loss whose phase check (an absolute 1e-2) the rounding of a large complex64
	gradient trips."""

	@staticmethod
	def forward(ctx, T, f):
		with full_f32_matmul():
			theta, Y = torch.linalg.eigh(T)
		ft, fp = values_and_derivatives(f, theta)
		K = divided_differences(theta, ft, fp)
		ctx.save_for_backward(Y, K)
		with full_f32_matmul():
			return (Y * ft[None, :].to(Y.dtype)) @ _h(Y)

	@staticmethod
	def backward(ctx, G):
		Y, K = ctx.saved_tensors
		with full_f32_matmul():
			return Y @ (K.to(Y.dtype) * (_h(Y) @ G @ Y)) @ _h(Y), None


def block_quadrature(out: BlockLanczosOutput, fun: Union[str, Callable, None], **kwargs) -> torch.Tensor:
	"""The matrix-valued Gauss rule ``Vᵀ f(A) V ≈ R0ᵀ [f(T)]₁₁ R0`` (b×b), exact when
	``deg·b ≥ n`` with an orthonormal basis. A complex ``T`` that carries a gradient takes
	:class:`_HermitianFunction`, the rest ``eigh`` and its own backward."""
	f = param_callable(fun, **kwargs) if isinstance(fun, str) else (fun or _identity)
	T = block_jacobi_dense(out.Ablocks, out.Bblocks)
	b = out.R0.shape[0]
	if T.is_complex() and T.requires_grad:
		F11 = _HermitianFunction.apply(T, f)[:b, :b]
		with full_f32_matmul():
			return _h(out.R0) @ F11 @ out.R0
	with full_f32_matmul():
		theta, Y = torch.linalg.eigh(T)
		Y1 = Y[:b, :]
		F11 = (Y1 * f(theta)[None, :].to(Y1.dtype)) @ _h(Y1)
		return _h(out.R0) @ F11 @ out.R0


def _identity(x):
	return x


def block_slq_samples(op, blocks, fun: Callable, deg: int, reorth: bool = True) -> torch.Tensor:
	"""``tr(Vᵀ f(A) V)/b``, real, for each block ``V (n, b)`` of ``blocks``: the samples of
	:func:`block_slq_trace`."""
	out = []
	for V in blocks:
		G = block_quadrature(_block_lanczos_core(op, V, deg=deg, reorth=reorth), fun)
		out.append(torch.real(torch.trace(G)) / V.shape[1])
	return torch.stack(out)


def block_slq_trace(
	A, fun: Union[str, Callable, None] = None, b: int = 8, deg: int = 20, nblocks: int = 16, pdf: str = "normal",
	reorth: bool = True, seed=None, full: bool = False, differentiable: bool = False, device="cuda", **kwargs,
):
	"""``tr f(A)`` by block stochastic Lanczos quadrature (``primate_tpu/block_krylov.py:214-253``).

	Each of ``nblocks`` isotropic blocks ``V (n, b)`` (block ``i`` drawn from ``seed``'s
	generator ``i``) gives the sample ``tr(Vᵀ f(A) V)/b``; the estimate is their mean, a float,
	or ``(estimate, samples)`` with ``full=True``. ``differentiable=True`` returns the mean
	as a tensor that autograd differentiates through the block recurrence, the QRs and the
	eigensolve. Other keywords are the builtin function's parameters.
	"""
	from .trace import _base_seed, batch_generator

	op = aslinop(A, device=device)
	n = op.shape[0]
	f = param_callable(fun, **kwargs) if isinstance(fun, str) else (fun or _identity)
	b = min(int(b), n)
	deg = int(max(1, min(deg, n // max(b, 1))))
	base = _base_seed(seed)
	dtype = real_dtype(torch.promote_types(op.dtype, torch.float32))
	blocks = (sample_isotropic(batch_generator(base, i, op.device), (n, b), pdf=pdf, dtype=dtype) for i in range(int(nblocks)))
	if differentiable:
		if full:
			raise ValueError("differentiable=True returns the estimate only")
		return torch.mean(block_slq_samples(op, blocks, f, deg, reorth))
	with torch.no_grad():
		samples = block_slq_samples(op, blocks, f, deg, reorth)
	est = float(torch.mean(samples))
	return (est, samples.cpu().numpy()) if full else est
