"""Implicit matrix functions ``f(A)`` through Lanczos quadrature.

Counterpart of ``MatrixFunction`` in ``primate_tpu/operators/special_ops.py:28-155,222-284``:
the constructor, ``stack_shape``, ``_lanczos`` and ``quad`` (Gauss rule). One
block Lanczos sweep and one batched tridiagonal eigensolve cover all probe
columns. ``matvec`` (one- and two-pass f(A)v), Gauss-Radau/Lobatto rules and
Gram operators are not ported yet.
"""

from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch

from ..special import param_callable
from .base import LinearOperator, aslinop

__all__ = ["MatrixFunction"]


class MatrixFunction(LinearOperator):
	r"""Implicit matrix function ``f(A) = U f(Λ) Uᵀ`` as a linear operator.

	``quad`` estimates ``x ↦ xᵀ f(A) x`` by Gauss quadrature on the Jacobi
	matrix of a degree-``deg`` Lanczos sweep, for a block of columns at once.

	Parameters:
		A: tensor / numpy array / LinearOperator to lift.
		fun: spectral function (builtin name or a callable on tensors).
		deg: Krylov expansion degree.
		orth: re-orthogonalization count (<0 or >deg means full).
		dtype: computation dtype (defaults to A's dtype).
		device: where a numpy ``A`` is put, the card unless ``"cpu"`` (a tensor or operator keeps its own).
		reorth_passes: classical Gram-Schmidt passes per re-orthogonalization.
		kwargs: ``rtol`` (breakdown tolerance) and the builtin function's parameters (e.g. ``t`` for exp).
	"""

	def __init__(
		self,
		A,
		fun: Union[str, Callable, None] = None,
		deg: int = 20,
		orth: int = 3,
		dtype: Optional[torch.dtype] = None,
		reorth_passes: int = 2,
		device="cuda",
		**kwargs,
	):
		if deg < 2:
			raise ValueError("Degree must be >= 2")
		self._A = aslinop(A, dtype=dtype, device=device)
		self.shape = self._A.shape
		self.dtype = dtype if dtype is not None else self._A.dtype
		self.device = self._A.device
		self._fun_scalar = fun is None or isinstance(fun, str)
		self.fun = param_callable(fun, **kwargs)
		self._deg = int(min(deg, self.shape[0]))
		self._orth = self._deg if (orth < 0 or orth > self._deg) else int(orth)
		self._rtol = kwargs.get("rtol", 1e-8)
		self._reorth_passes = int(reorth_passes)

	@property
	def stack_shape(self) -> Optional[Tuple[int, ...]]:
		"""Leading (stack) axes of ``quad`` outputs: ``()`` for a builtin, None
		for a callable, whose output shape only a call can tell."""
		return () if self._fun_scalar else None

	@property
	def degree(self) -> int:
		return self._deg

	@property
	def operator(self) -> LinearOperator:
		return self._A

	def _lanczos(self, X: torch.Tensor, ncv: int):
		from ..lanczos import lanczos_block_op

		return lanczos_block_op(
			self._A, X, deg=self._deg, ncv=ncv, orth=self._orth, rtol=self._rtol, reorth_passes=self._reorth_passes
		)

	def quad(self, x) -> torch.Tensor:
		"""Batched Lanczos-quadrature estimates of ``diag(xᵀ f(A) x)`` for ``x (n, b)`` → ``(b,)``."""
		from ..integrate import spectral_quad_form

		X = torch.as_tensor(x, dtype=self.dtype, device=self.device)
		X = X[:, None] if X.ndim == 1 else X
		if self.dtype.is_complex:
			raise NotImplementedError("MatrixFunction.quad of complex (Hermitian) operators is not ported yet")
		Xa = X.to(torch.promote_types(X.dtype, torch.float32))
		x_norm_sq = torch.sum(Xa * Xa, dim=0)
		ncv = int(np.clip(max(self._orth, 2), 2, self._deg))
		out = self._lanczos(X, ncv=ncv)  # quadrature needs only (α, β)
		vals = spectral_quad_form(out.alphas.T, out.betas[: self._deg - 1].T, self.fun)
		return (vals * x_norm_sq).to(self.dtype)
