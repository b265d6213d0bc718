"""Block Lanczos tridiagonalization on probe-major blocks.

Counterpart of ``primate_tpu/lanczos.py:60-142,204-415``. All nv probes advance
together; the JAX ``lax.scan`` over ``deg`` steps becomes a Python loop that
enqueues device work and never reads the device, so a sweep costs no host sync.
Without re-orthogonalization (``orth=0``) on float32 or float64 each step is
``op.lanczos_sweep_step``: on a DIA operator on the card two kernels and no
PyTorch op, carrying the residuals unnormalised with their guarded divisors so
that no pass normalises. With ``orth>0``, or a bfloat16 block (whose ``q_next``
the reference rounds to bfloat16 every step), each step calls
``op.lanczos_step(q_cur, q_prev, β)`` (on a DIA operator the stencil, β-axpy and α
kernel); the rest (``v −= α·q``, the CGS window, β = ‖v‖, the done flags and
``q_next``) stays in PyTorch.

Ported: ``orth=0`` and the masked classical Gram-Schmidt window for ``orth>0``,
with the coefficients (α, β) as the only output. Not ported yet: the returned
basis, ``coeffs`` (two-pass f(A)v), selective re-orthogonalization, a narrow
``basis_dtype`` and complex (Hermitian) operators.
"""

from typing import NamedTuple, Tuple

import numpy as np
import torch

from .ops.dia import lanczos_state

__all__ = ["LanczosOutput", "lanczos_block_op"]


class LanczosOutput(NamedTuple):
	"""alphas, betas: ``(deg, nv)``. ``betas[deg-1]`` is the final residual norm;
	the deg×deg tridiagonal uses ``betas[:deg-1]``."""

	alphas: torch.Tensor
	betas: torch.Tensor


def _validate_params(n: int, deg: int, orth: int, ncv: int) -> Tuple[int, int, int]:
	"""Clamp (deg, orth, ncv) with the reference's rules (``primate_tpu/lanczos.py:60-71``)."""
	deg = int(np.clip(deg, 1, n))
	orth = deg if (orth < 0 or orth > deg) else int(orth)
	ncv = int(np.clip(ncv, min(2, deg), deg))
	# A window shorter than orth cannot hold it: clamp (reference `lanczos.py:13-16`).
	orth = min(orth, ncv)
	return deg, orth, ncv


def lanczos_block_op(
	op, V0: torch.Tensor, deg: int, ncv: int, orth: int = 0, rtol: float = 1e-8, reorth_passes: int = 2
) -> LanczosOutput:
	"""Run ``deg`` Lanczos steps of ``op`` on the probe block ``V0 (n, nv)``.

	``ncv`` is the re-orthogonalization window's length; the last ``orth`` basis
	vectors in it are projected out of each new vector (``reorth_passes`` CGS passes).
	"""
	if V0.dtype.is_complex:
		raise NotImplementedError("complex (Hermitian) Lanczos is not ported yet")
	deg, orth, ncv = _validate_params(V0.shape[0], deg, orth, ncv)
	return _lanczos_core(
		op, V0.T.contiguous(), deg=deg, ncv=ncv, orth=orth, rtol=rtol, reorth_passes=reorth_passes
	)


def _lanczos_core(op, V0t: torch.Tensor, *, deg: int, ncv: int, orth: int, rtol: float, reorth_passes: int) -> LanczosOutput:
	nv, n = V0t.shape
	dtype, device = V0t.dtype, V0t.device
	acc = torch.promote_types(dtype, torch.float32)  # f32 accumulation for bf16 storage

	norm0 = torch.sqrt(torch.sum(V0t.to(acc) ** 2, dim=1))
	q0 = (V0t / torch.where(norm0 > 0, norm0, 1)[:, None].to(dtype)).to(dtype)
	residual_tol = float(np.sqrt(n) * rtol)
	alphas = torch.empty((deg, nv), dtype=acc, device=device)
	betas = torch.empty((deg, nv), dtype=acc, device=device)

	if orth == 0 and dtype == acc:
		state = lanczos_state(nv, acc, device)
		v_prev, v_cur = torch.zeros((nv, n), dtype=acc, device=device), q0
		for j in range(deg):
			v_prev, v_cur = v_cur, op.lanczos_sweep_step(v_cur, v_prev, state, alphas[j], betas[j], residual_tol)
		return LanczosOutput(alphas=alphas, betas=betas)

	# Re-orthogonalisation, or a storage dtype narrower than the accumulation
	# (bfloat16): q_next is rounded to the storage dtype every step, as in JAX
	# (``primate_tpu/lanczos.py:388``), which the unnormalised carry above cannot do.
	if orth > 0:
		Q_win = torch.zeros((ncv, nv, n), dtype=dtype, device=device)
		Q_win[0] = q0
		slot_ids = torch.arange(ncv, device=device)

	def _cgs_window(v, valid):
		# Broadcast products and sums over n, not matmuls: no contraction of
		# this sweep goes through torch.matmul, so TF32 never comes into it. A
		# later change that puts a matmul here must pin float32 precision.
		for _ in range(max(1, reorth_passes)):
			proj = torch.sum(Q_win * v[None, :, :], dim=2) * valid[:, None]
			v = v - torch.sum(Q_win * proj[:, :, None].to(acc), dim=0)
		return v

	q_prev, q_cur = torch.zeros((nv, n), dtype=dtype, device=device), q0
	beta_j = torch.zeros(nv, dtype=acc, device=device)
	done = torch.zeros(nv, dtype=torch.bool, device=device)
	for j in range(deg):
		v, alpha_j = op.lanczos_step(q_cur, q_prev, beta_j)
		v.addcmul_(alpha_j[:, None], q_cur.to(acc), value=-1)  # in place: v is a fresh tensor
		if orth > 0:
			age = (j - slot_ids) % ncv
			v = _cgs_window(v, ((age < orth) & (age <= j)).to(acc))
		beta_next = torch.sqrt(torch.sum(v * v, dim=1))
		newly_done = beta_next < residual_tol
		alphas[j] = torch.where(done, 0.0, alpha_j)
		betas[j] = torch.where(done, 0.0, beta_next)
		# Guarded divide: once β vanishes, q_next = 0 and the recurrence
		# self-extinguishes, so α/β emit zeros after breakdown as in JAX.
		q_next = v.div_(torch.where(beta_next > residual_tol, beta_next, torch.inf)[:, None]).to(dtype)
		if orth > 0:
			Q_win[(j + 1) % ncv] = q_next
		q_prev, q_cur, beta_j, done = q_cur, q_next, beta_next, done | newly_done
	return LanczosOutput(alphas=alphas, betas=betas)
