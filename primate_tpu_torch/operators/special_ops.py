"""Implicit matrix functions ``f(A)`` through Lanczos quadrature.

Counterpart of ``MatrixFunction`` and ``matrix_function`` in
``primate_tpu/operators/special_ops.py:28-316``. One block Lanczos sweep and one
batched tridiagonal eigensolve cover all probe columns: ``quad`` estimates
``xᵀ f(A) x`` by a Gauss (or Gauss-Radau/Lobatto) rule, ``matvec``/``matmat``
approximate ``f(A) x`` in the Krylov basis, in one pass over a stored basis or
in two passes that keep only O(n·nv) memory. A stacked family
(:func:`~primate_tpu_torch.special.stacked`) is evaluated from the same sweep.
``quad`` of a :class:`~primate_tpu_torch.operators.sparse.GramOperator` goes through
Golub-Kahan bidiagonalisation of the data operator (``primate_tpu/operators/special_ops.py:230-262``):
one ``A`` and one ``A†`` apply a step, at ``κ(A)``, not ``κ(A)²``. Complex (Hermitian)
operators run the same sweep with conjugated inner products: the expansion
coefficients are real, ``f(A)x`` is complex and ``quad`` returns real quadratic
forms (``primate_tpu/operators/special_ops.py:212,235-240``).

Also the FFT :class:`Toeplitz` operator and :func:`normalize_unit`, the shift and scale
of a spectrum into an interval (``primate_tpu/operators/special_ops.py:320-427``).
"""

from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch

from ..linalg import full_f32_matmul
from ..ops.dia import row_sq_norm
from ..special import param_callable
from ..tridiag import eigh_tridiag
from .base import LinearOperator, ScaledOperator, aslinop, torch_dtype

__all__ = ["MatrixFunction", "matrix_function", "Toeplitz", "normalize_unit"]

# The keywords the constructor passes on: the breakdown tolerance and the builtin
# functions' parameters (``special._cached_builtin``).
_FUN_KWARGS = ("rtol", "t", "a", "b", "q", "threshold")
QUAD_RULES = ("gauss", "radau_lo", "radau_hi", "lobatto")


class MatrixFunction(LinearOperator):
	r"""Implicit matrix function ``f(A) = U f(Λ) Uᵀ`` as a linear operator.

	``matvec``/``matmat`` approximate ``x ↦ f(A)x`` by a degree-``deg`` Krylov
	expansion ``‖x‖ · Q · Y · (f(θ) ∘ Y[0,:])ᵀ``; ``quad`` estimates
	``x ↦ xᵀ f(A) x`` by Gauss quadrature on the Jacobi matrix, for a block of
	columns at once.

	Parameters:
		A: tensor / numpy array / scipy matrix / LinearOperator to lift.
		fun: spectral function (builtin name, callable on tensors, or a stacked family).
		deg: Krylov expansion degree.
		orth: re-orthogonalization count (<0 or >deg means full).
		dtype: computation dtype (defaults to A's dtype).
		two_pass: f(A)x in two sweeps (O(n·nv) memory) or one (a stored basis);
			"auto" takes two when ``basis_dtype`` is narrower than ``dtype`` or the
			basis would pass 1 GiB.
		reorth_passes: classical Gram-Schmidt passes per re-orthogonalization.
		basis_dtype: storage dtype of the basis window (e.g. ``torch.bfloat16``).
		quad_rule: "gauss", or "radau_lo"/"radau_hi"/"lobatto" with node(s) fixed at
			the ends of ``interval`` (which must lie outside the spectrum).
		interval: ``(a, b)`` for the Radau and Lobatto rules.
		device: where a numpy or scipy ``A`` is put, the card unless ``"cpu"``.
		kwargs: ``rtol`` (breakdown tolerance) and the builtin function's parameters
			(``t``, ``a``, ``b``, ``q``, ``threshold``). Any other keyword raises.
	"""

	def __init__(
		self,
		A,
		fun: Union[str, Callable, None] = None,
		deg: int = 20,
		orth: int = 3,
		dtype=None,
		two_pass: Union[bool, str] = "auto",
		reorth_passes: int = 2,
		basis_dtype=None,
		quad_rule: str = "gauss",
		interval: Optional[tuple] = None,
		device="cuda",
		**kwargs,
	):
		unknown = sorted(set(kwargs) - set(_FUN_KWARGS))
		if unknown:
			raise TypeError(f"MatrixFunction() got unexpected keyword arguments {unknown}")
		if deg < 2:
			raise ValueError("Degree must be >= 2")
		if quad_rule not in QUAD_RULES:
			raise ValueError(f"Unknown quad_rule {quad_rule!r}")
		if quad_rule != "gauss" and interval is None:
			raise ValueError("radau/lobatto quad rules need interval=(a, b) endpoints outside the spectrum")
		if not (isinstance(two_pass, bool) or two_pass == "auto"):
			raise ValueError(f"two_pass must be True, False or 'auto', got {two_pass!r}")
		dtype = torch_dtype(dtype)
		self._A = aslinop(A, dtype=dtype, device=device)
		self.shape = self._A.shape
		self.dtype = dtype if dtype is not None else self._A.dtype
		self.device = self._A.device
		self.fun = param_callable(fun, **kwargs) if (fun is None or isinstance(fun, str)) else fun
		self._fun_scalar = fun is None or isinstance(fun, str)
		self._deg = int(min(deg, self.shape[0]))
		self._orth = self._deg if (orth < 0 or orth > self._deg) else int(orth)
		self._rtol = kwargs.get("rtol", 1e-8)
		self._two_pass = two_pass
		self._reorth_passes = int(reorth_passes)
		self._basis_dtype = torch_dtype(basis_dtype)
		self._quad_rule = quad_rule
		self._interval = None if interval is None else (float(interval[0]), float(interval[1]))

	@property
	def fun(self) -> Callable:
		"""The spectral function; assignable after construction (a name goes through the builtins)."""
		return self._fun

	@fun.setter
	def fun(self, value: Union[str, Callable, None]) -> None:
		self._fun_scalar = value is None or isinstance(value, str)
		if self._fun_scalar:
			value = param_callable(value)
		if not callable(value):
			raise TypeError("Function must be callable.")
		self._fun = value

	@property
	def stack_shape(self) -> Optional[Tuple[int, ...]]:
		"""Leading (stack) axes of ``quad`` and ``matvec`` outputs: ``()`` for a builtin,
		``(nt,)`` for a stacked family, None for a callable, whose output shape only a call can tell."""
		nout = getattr(self._fun, "nout", None)
		if nout is not None:
			return (int(nout),)
		return () if self._fun_scalar else None

	@property
	def degree(self) -> int:
		return self._deg

	@property
	def operator(self) -> LinearOperator:
		return self._A

	def float_tensors(self) -> tuple:
		return self._A.float_tensors()

	def _lanczos(self, X: torch.Tensor, ncv: int, return_basis: bool = True, coeffs=None):
		from ..lanczos import lanczos_block_op

		return lanczos_block_op(
			self._A, X, deg=self._deg, ncv=ncv, orth=self._orth, rtol=self._rtol, reorth_passes=self._reorth_passes,
			return_basis=return_basis, coeffs=coeffs, basis_dtype=self._basis_dtype,
		)

	def _modified_rule(self, d: torch.Tensor, e: torch.Tensor, beta_end: torch.Tensor):
		"""The configured Gauss-Radau/Lobatto rule on batched Jacobi ``(d, e)``."""
		from ..integrate import lobatto_rule, radau_rule

		a, b = self._interval
		if self._quad_rule == "radau_lo":
			return radau_rule(d, e, beta_end, a)
		if self._quad_rule == "radau_hi":
			return radau_rule(d, e, beta_end, b)
		return lobatto_rule(d, e, beta_end, a, b)

	def _use_two_pass(self, nv: int) -> bool:
		if isinstance(self._two_pass, bool):
			return self._two_pass
		# auto, rule 1: a narrowed basis window would cap the one-pass matvec at its precision.
		itemsize = torch.empty(0, dtype=self.dtype).element_size()
		if self._basis_dtype is not None and torch.empty(0, dtype=self._basis_dtype).element_size() < itemsize:
			return True
		# auto, rule 2: trade a second sweep for O(n·nv) memory past a 1 GiB basis.
		return self._deg * self.shape[0] * nv * itemsize > (1 << 30)

	def _coeffs(self, out) -> torch.Tensor:
		"""Expansion coefficients of f(T)e₁ in the Lanczos basis → ``(..., b, deg)`` (the
		leading axes those of a stacked family)."""
		a = out.alphas.T
		e = out.betas[: self._deg - 1].T
		rw, Y = eigh_tridiag(a, e)  # (b, deg), (b, deg, deg)
		w = self.fun(rw) * Y[:, 0, :]
		with full_f32_matmul():
			return torch.einsum("bij,...bj->...bi", Y, w)

	def _matmat(self, X: torch.Tensor) -> torch.Tensor:
		X = torch.as_tensor(X, dtype=self.dtype, device=self.device)
		x_norm = torch.linalg.vector_norm(X, dim=0)  # (b,)
		ncv_short = max(2, min(self._orth, self._deg))
		if self._use_two_pass(X.shape[1]):
			# Pass 1: coefficients only; pass 2: the same deterministic recurrence, accumulating y = Σ c_t q_t.
			c = self._coeffs(self._lanczos(X, ncv=ncv_short, return_basis=False))
			out = self._lanczos(X, ncv=ncv_short, return_basis=False, coeffs=torch.movedim(c, -1, 0))
			return (x_norm * out.y).to(self.dtype)  # (..., n, b)
		out = self._lanczos(X, ncv=self._deg)
		c = self._coeffs(out)
		# out.Q is (deg, n, b), slot t holding q_t; the window itself is (deg, b, n).
		Qw = out.Q.permute(0, 2, 1)
		y_dtype = torch.promote_types(Qw.dtype, c.dtype)
		with full_f32_matmul():
			y = torch.einsum("kbn,...bk->...nb", Qw.to(y_dtype), c.to(y_dtype))
		return (x_norm * y).to(self.dtype)

	def matvec(self, v: torch.Tensor) -> torch.Tensor:
		v = torch.as_tensor(v, device=self.device)
		return self._matmat(v[:, None])[..., 0]  # (n,), or (nt, n) for a stacked family

	def quad(self, x) -> torch.Tensor:
		"""Batched Lanczos-quadrature estimates of ``diag(xᵀ f(A) x)`` for ``x (n, b)`` → ``(b,)``,
		or ``(nt, b)`` for a stacked family (one sweep for the whole family). For a Hermitian
		operator ``x†f(A)x``, real, in the real dtype."""
		from ..integrate import spectral_quad_form
		from ..random import real_dtype

		from .sparse import GramOperator

		X = torch.as_tensor(x, dtype=self.dtype, device=self.device)
		X = X[:, None] if X.ndim == 1 else X
		x_norm_sq = row_sq_norm(X.to(torch.promote_types(X.dtype, torch.float32)).T)
		if isinstance(self._A, GramOperator):
			return (self._gram_quad(X) * x_norm_sq).to(real_dtype(self.dtype))
		ncv = int(np.clip(max(self._orth, 2), 2, self._deg))
		out = self._lanczos(X, ncv=ncv, return_basis=False)  # quadrature needs only (α, β)
		d, e = out.alphas.T, out.betas[: self._deg - 1].T
		if self._quad_rule != "gauss":
			nodes, weights = self._modified_rule(d, e, out.betas[self._deg - 1])
			vals = torch.sum(self.fun(nodes) * weights, dim=-1)
		else:
			vals = spectral_quad_form(d, e, self.fun)
		return (vals * x_norm_sq).to(real_dtype(self.dtype))


	def _gram_quad(self, X: torch.Tensor) -> torch.Tensor:
		"""The unit-probe quadrature of a Gram operator's ``f`` through Golub-Kahan: the rule of
		the Jacobi matrix ``BᵀB``, its nodes clamped at 0 (``BᵀB`` is PSD; ``eigh`` may give −ε).
		The steps are capped at ``min(m, n)``, where GKL is exhausted."""
		from ..bidiag import bidiag_jacobi, lanczos_bidiag_op
		from ..integrate import spectral_quad_form

		gram = self._A
		deg = int(min(self._deg, min(gram.A.shape)))
		out = lanczos_bidiag_op(
			gram.A, X, deg=deg, orth=min(self._orth, deg), rtol=self._rtol, reorth_passes=self._reorth_passes,
			adjoint=not gram.transpose_first, return_residual=self._quad_rule != "gauss",
		)
		d, e = bidiag_jacobi(out.alphas, out.betas)
		fun = self.fun
		if self._quad_rule != "gauss":
			# Radau/Lobatto on BᵀB: its next coupling is α_deg·β_deg; the interval is in σ² units.
			nodes, weights = self._modified_rule(d.T, e.T, out.alphas[deg - 1] * out.residual)
			return torch.sum(fun(torch.clamp(nodes, min=0.0)) * weights, dim=-1)
		return spectral_quad_form(d.T, e.T, lambda t: fun(torch.clamp(t, min=0.0)))


def matrix_function(A, fun: Union[str, Callable, None] = None, v=None, deg: int = 20, **kwargs):
	"""The operator ``f(A)``, or ``f(A) v`` when ``v`` is given (``primate_tpu/operators/special_ops.py:310-316``)."""
	M = MatrixFunction(A, fun=fun, deg=deg, **kwargs)
	return M if v is None else M @ torch.as_tensor(v, device=M.device)


class Toeplitz(LinearOperator):
	"""Matrix-free Toeplitz operator by FFT of its circulant embedding
	(``primate_tpu/operators/special_ops.py:320-368``): O(n log n) a product, O(n) storage.

	``c`` is the first column, ``r`` the first row (default ``c``: symmetric). The
	spectrum of the ``2n`` circulant is computed once. Real data takes real FFTs and
	gives a real product; complex data keeps its complex spectrum. A numpy ``c`` goes to
	``device``; a tensor keeps its own.
	"""

	def __init__(self, c, r=None, dtype=None, device="cuda"):
		dtype = torch_dtype(dtype)

		def tensor(x):
			x = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x), device=device)
			return x.to(dtype) if dtype is not None else x

		self.c = tensor(c)
		self.r = tensor(c if r is None else r).to(self.c.device)
		if self.r.shape != self.c.shape or self.c.ndim != 1:
			raise ValueError("First row and first column must be vectors of the same length.")
		n = self.c.shape[0]
		self.shape = (n, n)
		self.dtype = torch.promote_types(self.c.dtype, self.r.dtype) if dtype is None else dtype
		self.device = self.c.device
		d = torch.cat([self.c, torch.zeros(1, dtype=self.c.dtype, device=self.device), torch.flip(self.r[1:], [0])])
		d = d.to(self.dtype)
		self._real = not self.dtype.is_complex
		self._dfft = torch.fft.rfft(d) if self._real else torch.fft.fft(d)

	def float_tensors(self) -> tuple:
		return (self.c, self.r)

	def _apply(self, X: torch.Tensor, dim: int) -> torch.Tensor:
		"""The product along axis ``dim`` of ``X`` (0: node-major, 1: probe-major)."""
		n = self.shape[0]
		X = torch.as_tensor(X, device=self.device).to(self.dtype)
		spec = self._dfft[:, None] if dim == 0 else self._dfft[None, :]
		if self._real:
			Y = torch.fft.irfft(spec * torch.fft.rfft(X, n=2 * n, dim=dim), n=2 * n, dim=dim)
		else:
			Y = torch.fft.ifft(spec * torch.fft.fft(X, n=2 * n, dim=dim), dim=dim)
		return Y.narrow(dim, 0, n).to(self.dtype)

	def _matmat(self, V: torch.Tensor) -> torch.Tensor:
		return self._apply(V, 0)

	def matmat_t(self, Vt: torch.Tensor) -> torch.Tensor:
		return self._apply(Vt, 1)


def normalize_unit(A, interval: tuple = (-1, 1), deg: int = 64, seed=None) -> ScaledOperator:
	"""``s·(A + t·I)`` with the spectrum of ``A`` mapped into ``interval``
	(``primate_tpu/operators/special_ops.py:407-427``).

	α, the largest eigenvalue magnitude, comes from a fully re-orthogonalised Lanczos
	sweep of ``min(deg, n)`` steps (:func:`~primate_tpu_torch.lanczos.rayleigh_ritz`,
	inflated by 1% against the Ritz underestimate); ``[−α, α]`` goes onto ``[a, b]`` by
	``s = (b − a)/(2α)``, ``t = α(b + a)/(b − a)``. One read of α from the device.
	"""
	from ..lanczos import rayleigh_ritz

	a_lo, b_hi = interval
	if not b_hi > a_lo:
		raise ValueError("interval must be increasing")
	op = aslinop(A)
	k = int(min(deg, op.shape[0]))
	rw = rayleigh_ritz(op, deg=k, orth=-1, seed=seed)
	alpha = 1.01 * float(torch.max(torch.abs(rw)))
	s = (b_hi - a_lo) / (2.0 * alpha)
	t = alpha * (b_hi + a_lo) / (b_hi - a_lo)
	return ScaledOperator(op, t=t, s=s)
