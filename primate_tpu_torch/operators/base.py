"""Linear operator protocol on torch tensors, and the operator algebra.

Counterpart of ``primate_tpu/operators/base.py``. Operators apply to node-major
``(n, k)`` blocks (``matmat``) and to probe-major ``(k, n)`` blocks
(``matmat_t``, the layout the Lanczos sweep carries). ``lanczos_step`` and
``lanczos_sweep_step`` are the sweep's per-step hooks: operators with step kernels
(``DIAOperator``) override them.

The algebra (``A + B``, ``A - c``, ``c * A``, ``A / c``, ``-A``, ``A @ B``,
``A.H``, ``A.T``) builds :class:`AffineOperator`, :class:`ScaledOperator`,
:class:`ComposedOperator` and :class:`AdjointOperator` nodes that apply their
parts and never form a matrix. ``DeflatedOperator`` projects a subspace out of
an operator (adaptive Hutch++). :func:`aslinop` turns tensors, numpy arrays,
scipy sparse matrices, scipy ``LinearOperator``\\ s and protocol objects into
operators.
"""

from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from ..linalg import full_f32_matmul
from ..ops.dia import lanczos_sweep_step_ref, row_dot

__all__ = [
	"LinearOperator",
	"DenseOperator",
	"DeflatedOperator",
	"FunctionOperator",
	"AffineOperator",
	"ScaledOperator",
	"ComposedOperator",
	"AdjointOperator",
	"aslinop",
	"float_tensors_of",
	"is_linear_op",
	"is_valid_operator",
	"matmat",
	"quad_form",
	"torch_dtype",
]

_VALID_DTYPES = (torch.float32, torch.float64, torch.bfloat16, torch.complex64, torch.complex128)


def torch_dtype(dtype) -> Optional[torch.dtype]:
	"""The torch dtype of a torch dtype, a numpy dtype or a dtype name (None stays None)."""
	if dtype is None or isinstance(dtype, torch.dtype):
		return dtype
	dt = np.dtype(dtype)
	if dt.name == "bfloat16":
		return torch.bfloat16
	return torch.from_numpy(np.zeros(0, dtype=dt)).dtype


def float_tensors_of(*items) -> tuple:
	"""The floating-point tensors among ``items`` and, for operators among them, their
	:meth:`~LinearOperator.float_tensors`, each tensor once."""
	out, seen = [], set()
	for item in items:
		found = item.float_tensors() if isinstance(item, LinearOperator) else (item,)
		for t in found:
			if isinstance(t, torch.Tensor) and (t.is_floating_point() or t.is_complex()) and id(t) not in seen:
				seen.add(id(t))
				out.append(t)
	return tuple(out)


def _conj(x):
	"""The complex conjugate of a scalar coefficient (a number or a 0-d tensor)."""
	if isinstance(x, torch.Tensor):
		return x.conj()
	return x.conjugate() if isinstance(x, complex) else x


def _is_scalar(x) -> bool:
	return isinstance(x, (int, float, complex, np.number)) or (
		isinstance(x, (np.ndarray, torch.Tensor)) and getattr(x, "ndim", None) == 0
	)


class LinearOperator:
	"""Base class for matrix-free symmetric operators.

	Subclasses implement ``_matmat(V)`` on an ``(n, k)`` block and set ``shape``,
	``dtype`` and ``device``.
	"""

	shape: Tuple[int, int]
	dtype: torch.dtype
	device: torch.device
	# Leading axes of an apply's output beyond (n, k): none for a plain operator,
	# so the estimators need no trial apply to learn them.
	stack_shape: Tuple[int, ...] = ()

	# numpy defers to the reflected operators: ``np.eye(n) + op`` is one AffineOperator.
	__array_ufunc__ = None

	def _matmat(self, V: torch.Tensor) -> torch.Tensor:
		raise NotImplementedError

	def float_tensors(self) -> tuple:
		"""The floating-point tensors the operator's applies read, each once (the port's
		counterpart of a JAX operator's inexact pytree leaves): the tensors autograd can
		carry a gradient to, by :mod:`~primate_tpu_torch.autodiff` and the differentiable
		solve. Integer index tensors are left out; an operator that holds none gives ()."""
		return ()

	def matmat(self, V: torch.Tensor) -> torch.Tensor:
		return self._matmat(torch.as_tensor(V, device=self.device))

	def matvec(self, v: torch.Tensor) -> torch.Tensor:
		v = torch.as_tensor(v, device=self.device)
		return self._matmat(v[:, None])[..., 0]

	def matmat_t(self, Vt: torch.Tensor) -> torch.Tensor:
		"""Probe-major apply ``(A Vtᵀ)ᵀ`` on a ``(k, n)`` block (default: two transposes around ``matmat``)."""
		return self._matmat(Vt.T).T

	def lanczos_step(
		self, q_cur: torch.Tensor, q_prev: torch.Tensor, beta: torch.Tensor
	) -> Tuple[torch.Tensor, torch.Tensor]:
		"""One three-term recurrence step on probe-major ``(nv, n)`` blocks:
		``v = A·q_cur − β[:, None]·q_prev`` in ``promote_types(dtype, float32)`` and
		``α = Re Σ_r conj(q_cur)·v`` per probe, real (``primate_tpu/lanczos.py:309-315``)."""
		acc = torch.promote_types(q_cur.dtype, torch.float32)
		v = self.matmat_t(q_cur).to(acc) - beta[:, None] * q_prev.to(acc)
		return v, row_dot(q_cur.to(acc), v)

	def lanczos_sweep_step(
		self, v_cur: torch.Tensor, v_prev: torch.Tensor, state, alpha_out: torch.Tensor, beta_out: torch.Tensor,
		residual_tol: float,
	) -> torch.Tensor:
		"""One whole step of a sweep without re-orthogonalisation, on residual blocks
		carried unnormalised with their divisors in ``state``
		(:func:`~primate_tpu_torch.ops.dia.lanczos_sweep_step_ref`; default: that plain version)."""
		return lanczos_sweep_step_ref(self.matmat_t, v_cur, v_prev, state, alpha_out, beta_out, residual_tol)

	def rmatvec(self, v: torch.Tensor) -> torch.Tensor:
		# Estimation targets are symmetric; subclasses override when not.
		return self.matvec(v)

	def rmatmat(self, V: torch.Tensor) -> torch.Tensor:
		"""Adjoint block apply ``A† V``: ``rmatvec`` column by column unless a subclass has a block form."""
		V = torch.as_tensor(V, device=self.device)
		return torch.stack([self.rmatvec(V[:, j]) for j in range(V.shape[1])], dim=1)

	def rmatmat_t(self, Ut: torch.Tensor) -> torch.Tensor:
		"""Probe-major adjoint apply ``(A† Utᵀ)ᵀ`` on a ``(k, m)`` block."""
		return self.rmatmat(Ut.T).T

	def __matmul__(self, x):
		# operator @ operator composes (scipy LinearOperator semantics); operator @ array applies.
		if isinstance(x, LinearOperator):
			return ComposedOperator(self, x)
		x = torch.as_tensor(x, device=self.device)
		return self.matvec(x) if x.ndim == 1 else self.matmat(x)

	def todense(self) -> torch.Tensor:
		return self.matmat(torch.eye(self.shape[1], dtype=self.dtype, device=self.device))

	def __add__(self, other):
		if _is_scalar(other):  # A + c means A + c·I
			return AffineOperator(self, None, other)
		return AffineOperator(self, other, 1.0, device=self.device)

	__radd__ = __add__

	def __sub__(self, other):
		if _is_scalar(other):
			return AffineOperator(self, None, -other)
		return AffineOperator(self, ScaledOperator(other, s=-1.0, device=self.device), 1.0)

	def __rsub__(self, other):  # other − A
		if _is_scalar(other):  # c·I − A
			return ScaledOperator(self, t=-other, s=-1.0)
		return AffineOperator(other, ScaledOperator(self, s=-1.0), 1.0, device=self.device)

	def __mul__(self, c):
		if not _is_scalar(c):
			return NotImplemented
		return ScaledOperator(self, s=c)

	__rmul__ = __mul__

	def __truediv__(self, c):
		if not _is_scalar(c):
			return NotImplemented
		return ScaledOperator(self, s=1.0 / c)

	def __neg__(self):
		return ScaledOperator(self, s=-1.0)

	@property
	def H(self) -> "LinearOperator":
		"""The adjoint ``A†`` as an operator (applies through ``rmatmat``)."""
		return AdjointOperator(self, transpose=False)

	@property
	def T(self) -> "LinearOperator":
		"""The transpose ``Aᵀ`` (``= A†`` for real operators)."""
		return AdjointOperator(self, transpose=True)


class DenseOperator(LinearOperator):
	"""Dense matrix operator.

	A tensor keeps its device; anything else (a numpy array) goes to ``device``,
	the card unless the caller passes ``device="cpu"``. Its products go through
	``torch.matmul``. A float32 product on the card runs in full float32 only
	while TF32 stays off for matmul, which is PyTorch's default.
	"""

	def __init__(self, A, device="cuda"):
		self.A = A if isinstance(A, torch.Tensor) else torch.as_tensor(A, device=device)
		if self.A.ndim != 2:
			raise ValueError("Operator must be two dimensional.")
		self.shape = tuple(self.A.shape)
		self.dtype = self.A.dtype
		self.device = self.A.device

	def float_tensors(self) -> tuple:
		return float_tensors_of(self.A)

	def _matmat(self, V: torch.Tensor) -> torch.Tensor:
		return self.A @ V

	def matmat_t(self, Vt: torch.Tensor) -> torch.Tensor:
		return Vt @ self.A.T

	def rmatvec(self, v: torch.Tensor) -> torch.Tensor:
		return self.A.conj().T @ v

	def rmatmat(self, V: torch.Tensor) -> torch.Tensor:
		return self.A.conj().T @ torch.as_tensor(V, device=self.device)

	def rmatmat_t(self, Ut: torch.Tensor) -> torch.Tensor:
		return Ut @ self.A.conj()

	def todense(self) -> torch.Tensor:
		return self.A


class FunctionOperator(LinearOperator):
	"""An arbitrary callable ``V ↦ A V`` as an operator (``primate_tpu/operators/base.py:217-281``).

	The callable takes ``(n, k)`` blocks (``batched=False`` lifts a single-vector
	apply column by column) and, with ``captures``, those tensors first.
	``traceable=False`` marks a host callable (numpy, a C extension): it is handed
	numpy arrays on the host and its result is copied back to ``device``, each
	apply a round trip, as the JAX package's ``pure_callback`` bridge makes it.
	"""

	def __init__(
		self,
		fn: Callable,
		shape: Tuple[int, int],
		dtype=None,
		batched: bool = True,
		captures: tuple = (),
		traceable: bool = True,
		device="cuda",
	):
		self.fn = fn
		self.shape = tuple(int(s) for s in shape)
		self.dtype = torch_dtype(dtype) if dtype is not None else torch.get_default_dtype()
		self.batched = batched
		self.traceable = traceable
		self.captures = tuple(captures)
		self.device = torch.device(device)

	def float_tensors(self) -> tuple:
		return float_tensors_of(*self.captures) if self.traceable else ()

	def _call(self, args: tuple, V):
		if self.batched:
			return self.fn(*args, V)
		cols = [self.fn(*args, V[:, j]) for j in range(V.shape[1])]
		return torch.stack(cols, dim=1) if self.traceable else np.stack(cols, axis=1)

	def _matmat(self, V: torch.Tensor) -> torch.Tensor:
		if self.traceable:
			return self._call(self.captures, V)
		caps = tuple(np.asarray(c.cpu() if isinstance(c, torch.Tensor) else c) for c in self.captures)
		np_dtype = torch.empty(0, dtype=self.dtype).numpy().dtype
		out = np.asarray(self._call(caps, V.detach().cpu().numpy()), dtype=np_dtype).reshape(self.shape[0], V.shape[1])
		return torch.from_numpy(out).to(self.device)


class AffineOperator(LinearOperator):
	"""The pencil ``A + t·B`` (``B`` defaults to the identity; ``primate_tpu/operators/base.py:284-326``).

	``set_parameter`` returns a new operator; ``device`` is where a numpy ``A`` or ``B`` goes.
	"""

	def __init__(self, A, B=None, t=0.0, device="cuda"):
		self.A = aslinop(A, device=device)
		self.B = aslinop(B, device=self.A.device) if B is not None else None
		self.t = t
		self.shape, self.dtype, self.device = self.A.shape, self.A.dtype, self.A.device

	def set_parameter(self, t) -> "AffineOperator":
		return AffineOperator(self.A, self.B, t)

	def float_tensors(self) -> tuple:
		return float_tensors_of(self.A, *(() if self.B is None else (self.B,)), self.t)

	def _matmat(self, V: torch.Tensor) -> torch.Tensor:
		BV = V if self.B is None else self.B.matmat(V)
		return self.A.matmat(V) + self.t * BV

	def matmat_t(self, Vt: torch.Tensor) -> torch.Tensor:
		BV = Vt if self.B is None else self.B.matmat_t(Vt)
		return self.A.matmat_t(Vt) + self.t * BV

	def rmatmat(self, V: torch.Tensor) -> torch.Tensor:
		"""``A† V + conj(t)·B† V``: the adjoint of a sum of rectangular operators."""
		V = torch.as_tensor(V, device=self.device)
		BV = V if self.B is None else self.B.rmatmat(V)
		return self.A.rmatmat(V) + _conj(self.t) * BV

	def rmatvec(self, v: torch.Tensor) -> torch.Tensor:
		return self.rmatmat(torch.as_tensor(v, device=self.device)[:, None])[:, 0]

	def rmatmat_t(self, Ut: torch.Tensor) -> torch.Tensor:
		BU = Ut if self.B is None else self.B.rmatmat_t(Ut)
		return self.A.rmatmat_t(Ut) + _conj(self.t) * BU


class ScaledOperator(LinearOperator):
	"""``s · (A + t·I)``, the node of ``c * A``, ``A / c``, ``-A`` and ``c - A``
	(``primate_tpu/operators/special_ops.py:371-404``)."""

	def __init__(self, A, t=0.0, s=1.0, device="cuda"):
		self.A = aslinop(A, device=device)
		self.t, self.s = t, s
		self.shape, self.dtype, self.device = self.A.shape, self.A.dtype, self.A.device

	def float_tensors(self) -> tuple:
		return float_tensors_of(self.A, self.t, self.s)

	def _shifted(self) -> bool:
		"""Whether ``t`` is not the number 0 (a rectangular ``A`` takes no shift)."""
		return not (isinstance(self.t, (int, float)) and self.t == 0)

	def _matmat(self, V: torch.Tensor) -> torch.Tensor:
		AV = self.A.matmat(V)
		return self.s * (AV + self.t * V if self._shifted() else AV)

	def matmat_t(self, Vt: torch.Tensor) -> torch.Tensor:
		AV = self.A.matmat_t(Vt)
		return self.s * (AV + self.t * Vt if self._shifted() else AV)

	def rmatmat(self, V: torch.Tensor) -> torch.Tensor:
		"""``conj(s)·(A† V + conj(t)·V)``."""
		V = torch.as_tensor(V, device=self.device)
		AV = self.A.rmatmat(V)
		return _conj(self.s) * (AV + _conj(self.t) * V if self._shifted() else AV)

	def rmatvec(self, v: torch.Tensor) -> torch.Tensor:
		return self.rmatmat(torch.as_tensor(v, device=self.device)[:, None])[:, 0]

	def rmatmat_t(self, Ut: torch.Tensor) -> torch.Tensor:
		AU = self.A.rmatmat_t(Ut)
		return _conj(self.s) * (AU + _conj(self.t) * Ut if self._shifted() else AU)


class ComposedOperator(LinearOperator):
	"""The product ``A @ B``, applied right to left and never formed
	(``primate_tpu/operators/base.py:335-376``). The product of two symmetric
	operators is not symmetric in general: compose ``B.H @ A @ B`` for the estimators."""

	def __init__(self, A, B, device="cuda"):
		A = aslinop(A, device=device)
		B = aslinop(B, device=A.device)
		if A.shape[1] != B.shape[0]:
			raise ValueError(f"Composition shape mismatch: {A.shape} @ {B.shape}")
		self.A, self.B = A, B
		self.shape = (A.shape[0], B.shape[1])
		self.dtype = torch.promote_types(A.dtype, B.dtype)
		self.device = A.device

	def float_tensors(self) -> tuple:
		return float_tensors_of(self.A, self.B)

	def _matmat(self, V: torch.Tensor) -> torch.Tensor:
		return self.A.matmat(self.B.matmat(V))

	def matmat_t(self, Vt: torch.Tensor) -> torch.Tensor:
		return self.A.matmat_t(self.B.matmat_t(Vt))

	def rmatvec(self, v: torch.Tensor) -> torch.Tensor:
		return self.B.rmatvec(self.A.rmatvec(v))

	def rmatmat(self, V: torch.Tensor) -> torch.Tensor:
		return self.B.rmatmat(self.A.rmatmat(V))

	def rmatmat_t(self, Ut: torch.Tensor) -> torch.Tensor:
		return self.B.rmatmat_t(self.A.rmatmat_t(Ut))


class AdjointOperator(LinearOperator):
	"""``A†`` (``transpose=False``) or ``Aᵀ`` (``transpose=True``), through the base's
	``rmatmat`` (``primate_tpu/operators/base.py:379-427``); the two coincide for real operators."""

	def __init__(self, base, transpose: bool = False, device="cuda"):
		self.base = aslinop(base, device=device)
		self.transpose = bool(transpose)
		self.shape = (self.base.shape[1], self.base.shape[0])
		self.dtype, self.device = self.base.dtype, self.base.device

	def float_tensors(self) -> tuple:
		return self.base.float_tensors()

	def _conj_wrapped(self) -> bool:
		return self.transpose and self.dtype.is_complex

	def _matmat(self, V: torch.Tensor) -> torch.Tensor:
		if self._conj_wrapped():
			return torch.conj(self.base.rmatmat(torch.conj(V)))
		return self.base.rmatmat(V)

	def rmatvec(self, v: torch.Tensor) -> torch.Tensor:
		if self._conj_wrapped():
			return torch.conj(self.base.matvec(torch.conj(v)))
		return self.base.matvec(v)

	def rmatmat(self, V: torch.Tensor) -> torch.Tensor:
		if self._conj_wrapped():
			return torch.conj(self.base.matmat(torch.conj(V)))
		return self.base.matmat(V)

	@property
	def H(self) -> LinearOperator:
		return self.base if not self.transpose else AdjointOperator(self, transpose=False)

	@property
	def T(self) -> LinearOperator:
		return self.base if self.transpose else AdjointOperator(self, transpose=True)


def is_linear_op(A: Any) -> bool:
	"""Structural check: square, 2-d, with some way to apply it to a vector."""
	has_apply = any(hasattr(A, a) for a in ("__matmul__", "matmul", "dot", "matvec", "matmat"))
	ok = has_apply and hasattr(A, "shape") and len(A.shape) >= 2
	return bool(ok and A.shape[0] == A.shape[1])


def is_valid_operator(A: Any) -> torch.dtype:
	"""Check the operator protocol (square, with an apply) and return its element dtype
	as a torch dtype; a numpy dtype (a scipy matrix's) is accepted."""
	if not any(hasattr(A, a) for a in ("__matmul__", "matmul", "dot", "matvec", "matmat")):
		raise TypeError("Invalid operator; must have an overloaded 'matvec' or 'matmul' method")
	if not (hasattr(A, "shape") and len(A.shape) >= 2 and A.shape[0] == A.shape[1]):
		raise ValueError("This function only works with square, symmetric matrices!")
	dtype = getattr(A, "dtype", None)
	if dtype is None:
		dtype = np.asarray(A @ np.zeros(A.shape[1])).dtype
	dtype = torch_dtype(dtype)
	if dtype not in _VALID_DTYPES:
		raise TypeError("Only bfloat16, 32-/64-bit floats, and 64-/128-bit complex (Hermitian) are supported.")
	return dtype


def aslinop(A: Any, dtype=None, device="cuda") -> LinearOperator:
	"""Coerce anything operator-like into a :class:`LinearOperator`; operators pass through.

	A tensor keeps its device. A numpy array becomes a :class:`DenseOperator` and a
	scipy sparse matrix a :class:`~primate_tpu_torch.operators.sparse.CSROperator`,
	both on ``device`` (the card by default). A scipy ``LinearOperator`` becomes a
	host :class:`FunctionOperator` (its applies copy to the host and back), any
	other protocol object (``shape`` and ``matmat``/``@``/``matmul``/``dot``/``matvec``
	on tensors) a :class:`FunctionOperator` on ``device``.
	"""
	dtype = torch_dtype(dtype)
	if isinstance(A, LinearOperator):
		return A
	if isinstance(A, torch.Tensor):
		return DenseOperator(A if dtype is None else A.to(dtype))
	if isinstance(A, np.ndarray):
		return DenseOperator(torch.as_tensor(A, dtype=dtype, device=device))
	import scipy.sparse as sps
	import scipy.sparse.linalg as spsla

	if sps.issparse(A):
		from .sparse import CSROperator

		return CSROperator.from_scipy(A, dtype=dtype, device=device)
	if isinstance(A, spsla.LinearOperator):
		dt = dtype or torch_dtype(getattr(A, "dtype", None) or np.float64)
		return FunctionOperator(lambda V: A.matmat(V), A.shape, dtype=dt, traceable=False, device=device)
	if is_linear_op(A):
		shape = (A.shape[0], A.shape[1])
		dt = dtype or torch_dtype(getattr(A, "dtype", None))
		for name in ("matmat", "__matmul__", "matmul", "dot"):
			if hasattr(A, name):
				fn = getattr(A, name)
				return FunctionOperator(lambda V, fn=fn: fn(V), shape, dtype=dt, device=device)
		return FunctionOperator(lambda v: A.matvec(v), shape, dtype=dt, batched=False, device=device)
	raise TypeError(f"Cannot interpret {type(A)} as a linear operator")


def matmat(A: Any, V: torch.Tensor) -> torch.Tensor:
	"""Apply any operator-like to an ``(n, k)`` block, on ``V``'s device."""
	V = torch.as_tensor(V)
	return aslinop(A, device=V.device).matmat(V)


def quad_form(A: Any, V: torch.Tensor) -> torch.Tensor:
	"""Batched quadratic forms ``diag(Vᵀ A V)`` of an ``(n, k)`` block → ``(k,)``.

	Dispatches to ``A.quad`` when present (Lanczos quadrature for a
	``MatrixFunction``; ``(nt, k)`` for a stacked family). Otherwise one
	``matmat`` of the block, in whichever layout it lies: a DIA operator picks
	its probe-major or node-major kernel by that layout without a copy, and an
	operator with only a node-major kernel (BSR) takes a node-major block as it is.
	"""
	if hasattr(A, "quad"):
		return torch.atleast_1d(A.quad(V))
	op = aslinop(A)
	V = torch.as_tensor(V, dtype=op.dtype, device=op.device)
	V = V[:, None] if V.ndim == 1 else V
	AV = op.matmat(V)
	if op.dtype.is_complex:
		# Hermitian operator: v†Av is real — conjugate the bra, return real.
		return torch.real(torch.sum(V.conj() * AV, dim=0))
	return torch.sum(V * AV, dim=0)


class DeflatedOperator(LinearOperator):
	"""Projected operator ``P A P`` with ``P = I − VVᵀ``
	(``primate_tpu/operators/base.py:431-484`` with its default ``fill=0``).

	``V (n, k)`` has orthonormal columns. ``tr(A) = tr(VᵀAV) + tr(P A P)`` for any
	such ``V``, which is how adaptive Hutch++ spends its residual probes. The
	projections are skinny GEMMs in full float32 (TF32 off): a truncated
	projection leaks the deflated directions back.
	"""

	def __init__(self, A, V: torch.Tensor):
		self.A = aslinop(A)
		self.shape, self.dtype, self.device = self.A.shape, self.A.dtype, self.A.device
		self.V = torch.as_tensor(V, dtype=self.dtype, device=self.device)
		if self.V.ndim != 2 or self.V.shape[0] != self.shape[0]:
			raise ValueError("V must be (n, k).")

	def float_tensors(self) -> tuple:
		return float_tensors_of(self.A, self.V)

	def _vh(self, W: torch.Tensor) -> torch.Tensor:
		return (self.V.mH if self.V.is_complex() else self.V.T) @ W

	def _matmat(self, W: torch.Tensor) -> torch.Tensor:
		W = torch.as_tensor(W, dtype=self.dtype, device=self.device)
		with full_f32_matmul():
			AP = self.A.matmat(W - self.V @ self._vh(W))
			return AP - self.V @ self._vh(AP)
