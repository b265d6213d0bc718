"""Golub-Kahan-Lanczos bidiagonalisation of a rectangular operator, on probe-major blocks.

Counterpart of ``primate_tpu/bidiag.py``. ``deg`` steps build, per probe, an upper
bidiagonal ``B`` with ``A V = U B``: each step one ``A`` apply and one ``A†`` apply on
the whole ``(nv, ·)`` block, never the Gram product, so the recurrence conditions at
``κ(A)`` and the squared singular values appear only in the small Jacobi matrix
``BᵀB`` (:func:`bidiag_jacobi`). All nv probes advance together; the JAX
``lax.scan`` becomes a Python loop that enqueues device work and never reads the
device: a probe that breaks down (a residual below ``√max(m, n)·rtol``) is divided by
infinity into zeros, and its α and β are masked to 0 by a ``done`` flag on the card.
The applies go through the operator's probe-major ``matmat_t``/``rmatmat_t`` (on a
DIA operator ``dia_stencil_t`` on the bands and on the adjoint bands; on a BSR one
``bsr_spmm`` on the tiles and the transposed tiles). Complex operators conjugate the
bra of every inner product; α and β are real.
"""

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .ops.dia import row_sq_norm
from .random import real_dtype

__all__ = ["BidiagOutput", "bidiag_jacobi", "lanczos_bidiag", "lanczos_bidiag_op"]


class BidiagOutput(NamedTuple):
	"""Batched GKL results, probe axis last.

	alphas ``(deg, nv)``: the diagonal of B (α ≥ 0). betas ``(deg-1, nv)``: its
	superdiagonal. U ``(deg, m, nv)`` and V ``(deg, n, nv)``: the left and right Lanczos
	vectors (``return_basis=True``). residual ``(nv,)``: the next superdiagonal β_deg
	(``return_residual=True``, one more adjoint apply), the coupling a Gauss-Radau
	extension of ``BᵀB`` needs.
	"""

	alphas: torch.Tensor
	betas: torch.Tensor
	U: Optional[torch.Tensor] = None
	V: Optional[torch.Tensor] = None
	residual: Optional[torch.Tensor] = None


def bidiag_jacobi(alphas: torch.Tensor, betas: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
	"""The Jacobi matrix ``J = BᵀB`` as a tridiagonal ``(d, e)``: ``d_j = α_j² + β_{j-1}²``
	(β_0 = 0), ``e_j = α_j β_j``. Shapes ``(deg, ...)``, ``(deg-1, ...)`` in and out."""
	a2 = alphas.to(torch.promote_types(alphas.dtype, torch.float32)) ** 2
	b2 = betas.to(a2.dtype) ** 2
	d = a2 + torch.cat([torch.zeros_like(a2[:1]), b2], dim=0)
	e = alphas[:-1].to(a2.dtype) * betas.to(a2.dtype)
	return d, e


def _norm(x: torch.Tensor) -> torch.Tensor:
	return torch.sqrt(row_sq_norm(x))


def _guard(x: torch.Tensor, tol) -> torch.Tensor:
	"""``x`` where it exceeds ``tol``, else infinity: the guarded divisor."""
	return torch.where(x > tol, x, torch.inf)


def _masked_cgs(x: torch.Tensor, W: torch.Tensor, valid: torch.Tensor, passes: int) -> torch.Tensor:
	"""``x (nv, k)`` with the masked window ``W (ncv, nv, k)`` projected out, ``passes`` CGS passes;
	the bra is conjugated. Broadcast products and sums, no matmul: TF32 never enters."""
	W_bra = W.conj() if W.is_complex() else W
	for _ in range(max(1, passes)):
		proj = torch.sum(W_bra * x[None, :, :], dim=2) * valid[:, None]  # (ncv, nv)
		x = x - torch.sum(W * proj[:, :, None].to(x.dtype), dim=0)
	return x


def _bidiag_core(
	app_t, rapp_t, V0: torch.Tensor, *, deg: int, orth: int, rtol: float, reorth_passes: int,
	return_basis: bool, return_residual: bool = False,
) -> BidiagOutput:
	"""``deg`` GKL steps from ``V0 (n, nv)`` with the probe-major applies ``app_t (nv, n) → (nv, m)``
	and ``rapp_t (nv, m) → (nv, n)`` (``primate_tpu/bidiag.py:99-217``)."""
	n, nv = V0.shape
	dtype, device = V0.dtype, V0.device
	acc = torch.promote_types(dtype, torch.float32)
	r_acc = real_dtype(acc)

	Vt0 = V0.T.to(acc)
	norm0 = _norm(Vt0)
	v1 = Vt0 / torch.where(norm0 > 0, norm0, 1.0)[:, None]
	p = app_t(v1.to(dtype).contiguous()).to(acc)  # (nv, m)
	m = p.shape[1]
	tol = float(np.sqrt(max(m, n)) * rtol)
	alpha1 = _norm(p)
	u1 = p / _guard(alpha1, tol)[:, None]

	keep_window = return_basis or orth > 0
	ncv = deg if return_basis else int(np.clip(orth, 1, deg))
	U_win = V_win = None
	if keep_window:
		U_win = torch.zeros((ncv, nv, m), dtype=acc, device=device)
		V_win = torch.zeros((ncv, nv, n), dtype=acc, device=device)
		U_win[0], V_win[0] = u1, v1
	slot_ids = torch.arange(ncv, device=device)

	def window_mask(j: int) -> torch.Tensor:
		age = (j - slot_ids) % ncv
		return ((age < orth) & (age <= j)).to(r_acc)

	alphas = torch.empty((deg, nv), dtype=r_acc, device=device)
	betas = torch.empty((max(deg - 1, 0), nv), dtype=r_acc, device=device)
	alphas[0] = alpha1
	u, v, alpha = u1, v1, alpha1
	done = torch.zeros(nv, dtype=torch.bool, device=device)
	for j in range(deg - 1):
		valid = window_mask(j) if orth > 0 else None
		# Right vector: r = A†u_j − α_j v_j.
		r = rapp_t(u.to(dtype).contiguous()).to(acc) - alpha[:, None] * v
		if orth > 0:
			r = _masked_cgs(r, V_win, valid, reorth_passes)
		beta = _norm(r)
		v_next = r / _guard(beta, tol)[:, None]
		# Left vector: p = A v_{j+1} − β_j u_j.
		p = app_t(v_next.to(dtype).contiguous()).to(acc) - beta[:, None] * u
		if orth > 0:
			p = _masked_cgs(p, U_win, valid, reorth_passes)
		alpha_next = _norm(p)
		u_next = p / _guard(alpha_next, tol)[:, None]

		betas[j] = torch.where(done, 0.0, beta)
		alphas[j + 1] = torch.where(done | (beta < tol), 0.0, alpha_next)
		if keep_window:
			# v_{j+1} stays a basis vector whenever β_j survived, also on an α breakdown
			# (B's column j+1 still refers to it); u_{j+1} is exactly 0 after its own.
			slot = (j + 1) % ncv
			if return_basis:
				advance = ((~done) & (beta >= tol))[:, None]
				V_win[slot] = torch.where(advance, v_next, V_win[slot])
				U_win[slot] = torch.where(advance, u_next, U_win[slot])
			else:
				V_win[slot], U_win[slot] = v_next, u_next
		done = done | (beta < tol) | (alpha_next < tol)
		u, v, alpha = u_next, v_next, alpha_next

	residual = None
	if return_residual:
		# One more half-step: β_deg = ‖A†u_deg − α_deg v_deg‖; a done probe gives 0.
		r = rapp_t(u.to(dtype).contiguous()).to(acc) - alpha[:, None] * v
		if orth > 0:
			r = _masked_cgs(r, V_win, window_mask(deg - 1), reorth_passes)
		residual = torch.where(done, 0.0, _norm(r))
	return BidiagOutput(
		alphas=alphas,
		betas=betas,
		U=U_win.permute(0, 2, 1) if return_basis else None,  # (deg, m, nv)
		V=V_win.permute(0, 2, 1) if return_basis else None,  # (deg, n, nv)
		residual=residual,
	)


def lanczos_bidiag_op(
	op, V0: torch.Tensor, deg: int, orth: int = 0, rtol: float = 1e-8, reorth_passes: int = 2,
	return_basis: bool = False, adjoint: bool = False, return_residual: bool = False,
) -> BidiagOutput:
	"""The GKL core on an operator (``primate_tpu/bidiag.py:59-88``); ``adjoint=True``
	bidiagonalises ``A†`` (probes on the m side), the ``AA†`` side of a Gram operator."""
	if adjoint:
		app_t, rapp_t = op.rmatmat_t, op.matmat_t
	else:
		app_t, rapp_t = op.matmat_t, op.rmatmat_t
	return _bidiag_core(
		app_t, rapp_t, V0, deg=deg, orth=orth, rtol=rtol, reorth_passes=reorth_passes,
		return_basis=return_basis, return_residual=return_residual,
	)


def lanczos_bidiag(
	A, V0=None, deg: int = 20, orth: int = 0, rtol: float = 1e-8, reorth_passes: int = 2,
	return_basis: bool = False, seed=None, dtype=None, adjoint: bool = False, return_residual: bool = False,
	device="cuda",
) -> BidiagOutput:
	"""Golub-Kahan-Lanczos bidiagonalisation of a (rectangular) operator
	(``primate_tpu/bidiag.py:220-260``).

	``deg`` (clamped to ``min(m, n)``) steps, each one ``A`` and one ``A†`` apply on the
	probe block ``V0 (n, nv)`` (a vector is one probe; without ``V0`` one normal probe
	drawn from ``seed``, real also for a complex operator). ``orth`` re-orthogonalises
	both sides against that many previous vectors (−1: all). The singular values of ``B``
	approximate the extreme singular values of ``A``; :func:`bidiag_jacobi` gives the
	Jacobi matrix of ``A†A``. ``device`` is where a numpy or scipy ``A`` goes.
	"""
	from .operators.base import aslinop, torch_dtype
	from .trace import _base_seed, batch_generator

	op = aslinop(A, dtype=torch_dtype(dtype), device=device)
	m, n = op.shape
	deg = int(np.clip(deg, 1, min(m, n)))
	orth = deg if (orth < 0 or orth > deg) else int(orth)
	side = m if adjoint else n
	if V0 is None:
		g = batch_generator(_base_seed(seed), 0, op.device)
		V0 = torch.randn((side, 1), generator=g, device=op.device, dtype=real_dtype(op.dtype))
	V0 = torch.as_tensor(V0, device=op.device).to(op.dtype)
	V0 = V0[:, None] if V0.ndim == 1 else V0
	if V0.shape[0] != side:
		raise ValueError(f"V0 must have {side} rows; got {tuple(V0.shape)}")
	return lanczos_bidiag_op(
		op, V0, deg=deg, orth=orth, rtol=rtol, reorth_passes=reorth_passes,
		return_basis=return_basis, adjoint=adjoint, return_residual=return_residual,
	)
