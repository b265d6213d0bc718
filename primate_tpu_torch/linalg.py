"""Small dense linear-algebra updates behind the sketch estimators.

Counterpart of ``primate_tpu/linalg.py``: thin QR of a tall block (shifted
CholeskyQR3 with a Householder fallback), block QR append (CGS2) and the block
update of an upper-triangular inverse. The identities are exact algebra, so the
JAX package traces them under full matmul precision (``_hiprec``). Here every
function runs under :func:`full_f32_matmul`, which turns TF32 off for float32
matmuls on the card while it runs and restores the caller's setting after: a
caller who enabled TF32 does not silently lose XTrace's m = n exactness.
"""

import functools
from contextlib import contextmanager
from typing import Optional, Tuple

import torch

__all__ = ["full_f32_matmul", "tall_qr", "update_trinv", "update_trinv_block", "qr_append", "colwise_dot"]


@contextmanager
def full_f32_matmul():
	"""Run float32 matmuls in full float32 (no TF32) inside the block; restore the caller's setting after.

	Only the cuBLAS TF32 flag is read and set: newer PyTorch refuses the global
	``get_float32_matmul_precision()`` once a caller has mixed its legacy and new
	precision switches.
	"""
	prev = torch.backends.cuda.matmul.allow_tf32
	torch.backends.cuda.matmul.allow_tf32 = False
	try:
		yield
	finally:
		torch.backends.cuda.matmul.allow_tf32 = prev


def full_f32(fn):
	"""Decorator form of :func:`full_f32_matmul`."""

	@functools.wraps(fn)
	def wrapped(*a, **k):
		with full_f32_matmul():
			return fn(*a, **k)

	return wrapped


def _h(X: torch.Tensor) -> torch.Tensor:
	"""Conjugate transpose (a plain transpose for real tensors)."""
	return X.mH if X.is_complex() else X.T


@full_f32
def _shifted_cholqr3(Y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
	"""Shifted CholeskyQR3 (Fukaya et al. 2018): thin QR of a tall block through
	three m×m Choleskys and triangular solves (``primate_tpu/linalg.py:39-82``).

	The first Cholesky is shifted by ``s = 11(nm + m(m+1))·ε·‖G‖_F`` so it cannot
	break down; two plain CholeskyQR passes restore orthogonality. A
	rank-deficient block makes a refinement Cholesky fail; then Householder QR
	runs instead. Deciding that reads one flag from the device per call.
	"""
	n, m = Y.shape
	eps = torch.finfo(Y.real.dtype if Y.is_complex() else Y.dtype).eps
	G = _h(Y) @ Y
	s = 11.0 * (n * m + m * (m + 1)) * eps * torch.linalg.matrix_norm(G)
	# Q = Y R⁻¹ solved as (L⁻¹ Yᴴ)ᴴ with L = Rᴴ: the solve's column-major result
	# comes back as a node-major (row-major) Q, which the sparse kernels read without a copy.
	L, fails = torch.linalg.cholesky_ex(G + s * torch.eye(m, dtype=G.dtype, device=G.device))
	Q = _h(torch.linalg.solve_triangular(L, _h(Y), upper=False))
	R = _h(L)
	for _ in range(2):
		L2, info = torch.linalg.cholesky_ex(_h(Q) @ Q)
		Q = _h(torch.linalg.solve_triangular(L2, _h(Q), upper=False))
		R = _h(L2) @ R
		fails = fails + info
	ok = (fails == 0) & torch.isfinite(R).all() & torch.isfinite(Q).all()
	if not bool(ok):  # the one device→host read
		return torch.linalg.qr(Y, mode="reduced")
	return Q, R


def tall_qr(Y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
	"""Thin QR: shifted CholeskyQR3 for tall blocks (n ≥ 8m), ``torch.linalg.qr`` otherwise."""
	n, m = Y.shape
	if m == 0 or n < 8 * m:
		with full_f32_matmul():
			return torch.linalg.qr(Y, mode="reduced")
	return _shifted_cholqr3(Y)


@full_f32
def update_trinv(B_inv: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
	"""Inverse of ``[[B, b[:n]], [0, b[n]]]`` from ``B⁻¹`` (``B`` upper-triangular ``n×n``)."""
	b = b.reshape(-1)
	n = B_inv.shape[0]
	if B_inv.shape != (n, n) or b.shape[0] != n + 1:
		raise ValueError("B must be n x n and `b` must have length `n + 1`")
	out = torch.zeros((n + 1, n + 1), dtype=torch.promote_types(B_inv.dtype, b.dtype), device=B_inv.device)
	inv_corner = torch.reciprocal(b[-1])
	out[:n, :n] = B_inv
	out[n, n] = inv_corner
	out[:n, n] = -inv_corner * (B_inv @ b[:n])
	return out


@full_f32
def update_trinv_block(R_inv: torch.Tensor, B: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
	"""Inverse of the block upper-triangular ``[[R, B], [0, C]]`` from ``R⁻¹``:
	``[[R⁻¹, −R⁻¹ B C⁻¹], [0, C⁻¹]]``."""
	m, b = R_inv.shape[0], C.shape[0]
	C_inv = torch.linalg.solve_triangular(C, torch.eye(b, dtype=C.dtype, device=C.device), upper=True)
	out = torch.zeros((m + b, m + b), dtype=torch.promote_types(R_inv.dtype, C.dtype), device=C.device)
	out[:m, :m] = R_inv
	out[m:, m:] = C_inv
	if m > 0:
		out[:m, m:] = -(R_inv @ B) @ C_inv
	return out


@full_f32
def qr_append(
	Q: Optional[torch.Tensor], R: Optional[torch.Tensor], Y: torch.Tensor, reorth_passes: int = 2
) -> Tuple[torch.Tensor, torch.Tensor]:
	"""Append columns ``Y (n × b)`` to a thin QR ``Q R``: ``reorth_passes`` CGS sweeps
	against ``Q``, a QR of the remainder, and the bordered ``R``."""
	if Q is None or Q.shape[1] == 0:
		return tall_qr(Y)
	m, b = Q.shape[1], Y.shape[1]
	B = torch.zeros((m, b), dtype=Y.dtype, device=Y.device)
	Z = Y
	for _ in range(max(1, reorth_passes)):
		proj = _h(Q) @ Z
		Z = Z - Q @ proj
		B = B + proj
	Q2, C = tall_qr(Z)
	R_new = torch.zeros((m + b, m + b), dtype=Y.dtype, device=Y.device)
	R_new[:m, :m] = R
	R_new[:m, m:] = B
	R_new[m:, m:] = C
	return torch.cat([Q, Q2], dim=1), R_new


def colwise_dot(X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
	"""Columnwise dots ``diag(X†Y)`` as a ``(k, 1)`` column."""
	return torch.sum(X.conj() * Y, dim=0)[:, None]
