"""Linear operator protocol on torch tensors.

Counterpart of ``primate_tpu/operators/base.py``. Operators apply to node-major
``(n, k)`` blocks (``matmat``) and to probe-major ``(k, n)`` blocks
(``matmat_t``, the layout the Lanczos sweep carries). ``lanczos_step`` is the
sweep's per-step hook: operators with a fused kernel (``DIAOperator``) override it.
"""

from typing import Any, Tuple

import numpy as np
import torch

__all__ = ["LinearOperator", "DenseOperator", "aslinop", "is_valid_operator", "quad_form"]


class LinearOperator:
	"""Base class for matrix-free symmetric operators.

	Subclasses implement ``_matmat(V)`` on an ``(n, k)`` block and set ``shape``,
	``dtype`` and ``device``.
	"""

	shape: Tuple[int, int]
	dtype: torch.dtype
	device: torch.device

	def _matmat(self, V: torch.Tensor) -> torch.Tensor:
		raise NotImplementedError

	def matmat(self, V: torch.Tensor) -> torch.Tensor:
		return self._matmat(torch.as_tensor(V, device=self.device))

	def matvec(self, v: torch.Tensor) -> torch.Tensor:
		v = torch.as_tensor(v, device=self.device)
		return self._matmat(v[:, None])[:, 0]

	def matmat_t(self, Vt: torch.Tensor) -> torch.Tensor:
		"""Probe-major apply ``(A Vtᵀ)ᵀ`` on a ``(k, n)`` block (default: two transposes around ``matmat``)."""
		return self._matmat(Vt.T).T

	def lanczos_step(
		self, q_cur: torch.Tensor, q_prev: torch.Tensor, beta: torch.Tensor
	) -> Tuple[torch.Tensor, torch.Tensor]:
		"""One three-term recurrence step on probe-major ``(nv, n)`` blocks:
		``v = A·q_cur − β[:, None]·q_prev`` and ``α = Σ_r v·q_cur`` per probe,
		both in ``promote_types(dtype, float32)`` (``primate_tpu/lanczos.py:309-315``)."""
		acc = torch.promote_types(q_cur.dtype, torch.float32)
		v = self.matmat_t(q_cur).to(acc) - beta[:, None].to(acc) * q_prev.to(acc)
		return v, torch.sum(v * q_cur.to(acc), dim=1)

	def rmatvec(self, v: torch.Tensor) -> torch.Tensor:
		# Estimation targets are symmetric; subclasses override when not.
		return self.matvec(v)

	def __matmul__(self, x):
		x = torch.as_tensor(x, device=self.device)
		return self.matvec(x) if x.ndim == 1 else self.matmat(x)

	def todense(self) -> torch.Tensor:
		return self.matmat(torch.eye(self.shape[1], dtype=self.dtype, device=self.device))


class DenseOperator(LinearOperator):
	"""Dense matrix operator.

	Its products go through ``torch.matmul``. A float32 product on the card runs
	in full float32 only while TF32 stays off for matmul, which is PyTorch's default.
	"""

	def __init__(self, A):
		self.A = torch.as_tensor(A)
		if self.A.ndim != 2:
			raise ValueError("Operator must be two dimensional.")
		self.shape = tuple(self.A.shape)
		self.dtype = self.A.dtype
		self.device = self.A.device

	def _matmat(self, V: torch.Tensor) -> torch.Tensor:
		return self.A @ V

	def matmat_t(self, Vt: torch.Tensor) -> torch.Tensor:
		return Vt @ self.A.T

	def rmatvec(self, v: torch.Tensor) -> torch.Tensor:
		return self.A.conj().T @ v

	def todense(self) -> torch.Tensor:
		return self.A


def is_valid_operator(A: Any) -> torch.dtype:
	"""Check the operator protocol (square, with an apply) and return its element dtype."""
	if not any(hasattr(A, a) for a in ("__matmul__", "matvec", "matmat")):
		raise TypeError("Invalid operator; must have an overloaded 'matvec' or 'matmul' method")
	if not (hasattr(A, "shape") and len(A.shape) >= 2 and A.shape[0] == A.shape[1]):
		raise ValueError("This function only works with square, symmetric matrices!")
	dtype = A.dtype
	if dtype not in (torch.float32, torch.float64, torch.bfloat16, torch.complex64, torch.complex128):
		raise TypeError("Only bfloat16, 32-/64-bit floats, and 64-/128-bit complex (Hermitian) are supported.")
	return dtype


def aslinop(A: Any, dtype=None) -> LinearOperator:
	"""Coerce a tensor or numpy array into a :class:`DenseOperator`; operators pass through."""
	if isinstance(A, LinearOperator):
		return A
	if isinstance(A, (torch.Tensor, np.ndarray)):
		return DenseOperator(torch.as_tensor(A, dtype=dtype))
	raise TypeError(f"Cannot interpret {type(A)} as a linear operator (sparse formats other than DIA are not ported yet)")


def quad_form(A: Any, V: torch.Tensor) -> torch.Tensor:
	"""Batched quadratic forms ``diag(Vᵀ A V)`` of an ``(n, k)`` block → ``(k,)``.

	Dispatches to ``A.quad`` when present (Lanczos quadrature for a
	``MatrixFunction``). Otherwise the forms are taken probe-major through
	``matmat_t``: a probe block drawn by ``random.sample_isotropic`` is probe-major
	in memory, so ``V.T`` needs no copy, and a DIA operator applies its stencil kernel.
	"""
	if hasattr(A, "quad"):
		return torch.atleast_1d(A.quad(V))
	op = aslinop(A)
	V = torch.as_tensor(V, dtype=op.dtype, device=op.device)
	Vt = (V[:, None] if V.ndim == 1 else V).T.contiguous()
	AVt = op.matmat_t(Vt)
	if op.dtype.is_complex:
		# Hermitian operator: v†Av is real — conjugate the bra, return real.
		return torch.real(torch.sum(Vt.conj() * AVt, dim=1))
	return torch.sum(Vt * AVt, dim=1)
