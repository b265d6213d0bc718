"""Matrix-free linear solvers: batched (preconditioned) conjugate gradients.

Counterpart of ``primate_tpu/solvers.py``. It completes the Gaussian-process
workflow: ``logdet(K)`` comes from SLQ (:func:`~primate_tpu_torch.autodiff.logdet`),
the quadratic term ``yᵀK⁻¹y`` from CG on the same operator. All right-hand sides
advance together, one operator apply on the whole block an iteration, each
column stopping on its own (masked). The state is carried probe-major, ``(k, n)``,
as the Lanczos sweep carries its probes, so a DIA operator's apply is the
probe-major stencil kernel.

The JAX package runs the loop as a ``lax.while_loop`` whose stop test stays on
the device. Here it is a Python loop that reads the done flags once an
iteration (one device→host sync). The differentiable solve is a
``torch.autograd.Function`` in place of ``lax.custom_linear_solve(symmetric=True)``:
its backward is another solve with the same operator, and the operator's
tensors (:meth:`~primate_tpu_torch.operators.base.LinearOperator.float_tensors`)
are pulled back through ``matmat(X)``. Preconditioners are solve machinery, built
from detached tensors and never differentiated. Complex (Hermitian) operators
solve with conjugated inner products (real α, β and stop state) and are not
differentiated, as in the JAX package (``primate_tpu/solvers.py:145-148,243-258``).
"""

import warnings
from typing import Callable, NamedTuple, Optional, Union

import numpy as np
import torch

from .linalg import full_f32, tall_qr
from .ops.dia import row_dot
from .operators.base import aslinop
from .random import real_dtype, sample_isotropic

__all__ = ["DiagPreconditioner", "NystromPreconditioner", "CGState", "cg", "nystrom_precond", "nystrom_core", "solve"]


def _acc(dtype: torch.dtype) -> torch.dtype:
	return torch.promote_types(dtype, torch.float32)


class DiagPreconditioner:
	"""Jacobi preconditioner: ``Z = D⁻¹ R`` as an elementwise multiply."""

	def __init__(self, inv_diag: torch.Tensor):
		self.inv_diag = inv_diag

	def apply_t(self, Rt: torch.Tensor) -> torch.Tensor:  # probe-major (k, n)
		return Rt * self.inv_diag[None, :]


class NystromPreconditioner:
	"""Randomized Nyström preconditioner (Frangella-Tropp-Udell 2021).

	From a rank-``s`` Nyström approximation ``Â = U Λ Uᵀ`` of SPD ``A``, the
	preconditioner ``P⁻¹ = (λ_s+μ)·U(Λ+μ)⁻¹Uᵀ + (I − UUᵀ)`` clusters the top of
	the spectrum at ``λ_s + μ``, so PCG converges at the rate of the deflated
	condition number. Each application is two skinny GEMMs, in full float32.
	"""

	def __init__(self, U: torch.Tensor, coef: torch.Tensor):
		self.U = U  # (n, s) orthonormal
		self.coef = coef  # (s,) = (λ_s+μ)/(λ_i+μ) − 1

	@full_f32
	def apply_t(self, Rt: torch.Tensor) -> torch.Tensor:  # probe-major (k, n)
		# Row-major P⁻¹: (UU†r)ᵀ = rᵀ·conj(U)·Uᵀ (conj is a no-op for real U).
		C = Rt @ self.U.conj()  # (k, s)
		return Rt + (C * self.coef[None, :]) @ self.U.T


def nystrom_precond(A, rank: int = 64, mu: float = 0.0, seed=None, device="cuda") -> NystromPreconditioner:
	"""Build a rank-``rank`` :class:`NystromPreconditioner` for SPD ``A`` (+μI)
	(``primate_tpu/solvers.py:76-120``). The Gaussian test block Ω is drawn from the
	generator keyed ``(seed, 0)`` on the operator's device: real for a real operator; for
	a complex one a complex Gaussian, real and imaginary parts each of variance ½, as the
	JAX package's randomized eigensolvers sketch (``primate_tpu/eigen.py:611-619``). A
	numpy ``A`` goes to ``device``."""
	from .trace import _base_seed, batch_generator

	op = aslinop(A, device=device)
	n = op.shape[0]
	s = int(max(1, min(rank, n)))
	g = batch_generator(_base_seed(seed), 0, op.device)
	Om = sample_isotropic(g, (n, s), pdf="normal", dtype=real_dtype(op.dtype))
	if op.dtype.is_complex:
		Om = torch.complex(Om, sample_isotropic(g, (n, s), pdf="normal", dtype=real_dtype(op.dtype))) * float(np.sqrt(0.5))
	return nystrom_core(op, Om, mu)


@torch.no_grad()
@full_f32
def nystrom_core(op, Om: torch.Tensor, mu: float = 0.0) -> NystromPreconditioner:
	"""The preconditioner from a given Gaussian test block ``Om (n, s)``: a QR of Ω, one
	operator apply, a Cholesky, an ``s×s`` triangular inverse and ``eigh`` of the ``s×s``
	Gram matrix. A failed Cholesky (a rank-collapsed sketch) gives ``P = I``. Hermitian
	operators conjugate every bra (``primate_tpu/solvers.py:90-98``)."""
	n, s = Om.shape
	acc = _acc(op.dtype)
	h = lambda X: X.mH if X.is_complex() else X.T  # noqa: E731
	Om, _ = tall_qr(Om.to(acc))
	Y = op.matmat(Om.to(op.dtype)).to(acc)
	finfo = torch.finfo(real_dtype(acc))
	nu = finfo.eps * torch.linalg.vector_norm(Y) / float(np.sqrt(n))
	Y = Y + nu * Om
	L, info = torch.linalg.cholesky_ex(0.5 * ((h(Om) @ Y) + (h(Y) @ Om)))  # ½(Ω†Y + Y†Ω)
	L = torch.where(info == 0, L, torch.nan)  # a failed factor is NaN, as JAX's Cholesky returns
	# A small (s×s) triangular inverse and a GEMM instead of a solve with an (s, n) right-hand side.
	L_inv = torch.linalg.solve_triangular(L, torch.eye(s, dtype=acc, device=L.device), upper=False)
	B = Y @ h(L_inv)  # (n, s) = Y L⁻ᴴ
	# Left singular vectors by eigh of the small Gram matrix instead of an (n×s) SVD. A
	# non-finite Gram matrix (the failed factor) goes to eigh as the identity, which
	# LAPACK takes, and its preconditioner is zeroed below.
	G = h(B) @ B
	ok = torch.isfinite(G).all()
	d, W = torch.linalg.eigh(torch.where(ok, G, torch.eye(s, dtype=acc, device=G.device)))
	d, W = torch.flip(d, (0,)), torch.flip(W, (1,))  # descending
	safe = torch.clamp_min(d, finfo.tiny)
	U = B @ (W * torch.rsqrt(safe)[None, :])
	lam = torch.clamp_min(d - nu, 0.0)
	# Floors (primate_tpu/solvers.py:103-115): λ_s at √eps·λ_max, so the top subspace is
	# damped, never annihilated; the denominators at λ_s, so a rank-deficient tail stays at scale 1.
	lam_max = torch.clamp_min(lam[0], finfo.tiny)
	lam_s = torch.maximum(lam[-1], float(np.sqrt(finfo.eps)) * lam_max)
	coef = (lam_s + mu) / (torch.maximum(lam, lam_s) + mu) - 1.0
	coef = torch.where(ok & torch.isfinite(coef), coef, 0.0)
	U = torch.where(torch.isfinite(U), U, 0.0)
	return NystromPreconditioner(U=U, coef=coef)


class CGState(NamedTuple):
	"""The loop's state, probe-major: ``X``, ``R``, ``P`` ``(k, n)``; ``rs``, ``done`` ``(k,)``."""

	it: int
	X: torch.Tensor  # current iterates
	R: torch.Tensor  # residuals
	P: torch.Tensor  # search directions
	rs: torch.Tensor  # ⟨r, z⟩ per column, in the accumulation dtype
	done: torch.Tensor  # bool


@torch.no_grad()
def _cg_loop(
	matmat_t: Callable, Bt: torch.Tensor, X0t: Optional[torch.Tensor], pre, rtol, maxiter: int
) -> CGState:
	"""The CG iteration on probe-major blocks (``primate_tpu/solvers.py:132-181``).

	``Bt (k, n)`` right-hand sides, ``X0t`` the start (None: zero, and no apply for the
	first residual), ``rtol`` a float or a ``(k,)`` tensor. Stops at ``maxiter`` or
	when every column has ``‖r‖ ≤ rtol·‖b‖``; reads the done flags from the device
	once an iteration."""
	dtype = Bt.dtype
	acc = _acc(dtype)
	Bt = Bt.contiguous()
	# Hermitian operators: ⟨x, y⟩ = Re Σ conj(x)·y, so α, β and the stop state are real.
	inner = row_dot
	B_acc = Bt.to(acc)
	if X0t is None:
		X = torch.zeros_like(B_acc)
		R = B_acc.clone()
	else:
		X = X0t.to(acc).contiguous()
		R = (Bt - matmat_t(X0t.to(dtype).contiguous())).to(acc)
	Z = pre.apply_t(R) if pre is not None else R
	P = Z.clone() if Z is R else Z
	b_norm2 = inner(B_acc, B_acc)
	tol2 = torch.as_tensor(rtol, dtype=b_norm2.dtype, device=b_norm2.device) ** 2 * torch.clamp_min(
		b_norm2, torch.finfo(b_norm2.dtype).tiny
	)
	r2 = inner(R, R)
	rs = r2 if pre is None else inner(R, Z)
	done = r2 <= tol2
	it = 0
	while it < maxiter and not bool(done.all()):  # the one device→host read an iteration
		AP = matmat_t(P.to(dtype)).to(acc)
		pAp = inner(P, AP)
		alpha = torch.where(done | (pAp == 0), 0.0, rs / torch.where(pAp == 0, 1.0, pAp))
		X.addcmul_(alpha[:, None], P)
		R.addcmul_(alpha[:, None], AP, value=-1)
		del AP
		Z = pre.apply_t(R) if pre is not None else R
		r2 = inner(R, R)
		rs_new = r2 if pre is None else inner(R, Z)
		done = done | (r2 <= tol2)
		beta = torch.where(done | (rs == 0), 0.0, rs_new / torch.where(rs == 0, 1.0, rs))
		P.mul_(beta[:, None]).add_(Z)
		rs = rs_new
		it += 1
	return CGState(it=it, X=X, R=R, P=P, rs=rs, done=done)


class _Solve(torch.autograd.Function):
	"""``X = A⁻¹ B`` by CG, differentiable in ``B`` and in the operator's tensors.

	Backward (``lax.custom_linear_solve(symmetric=True)``, ``primate_tpu/solvers.py:284-296``):
	``B̄ = A⁻¹ X̄`` by the same solve, and the operator's tensors pulled back through
	``matmat(X)`` with cotangent ``−B̄``."""

	@staticmethod
	def forward(ctx, op, pre, maxiter, rtol, B, *tensors):
		ctx.op, ctx.pre, ctx.maxiter = op, pre, maxiter
		X = _cg_loop(op.matmat_t, B.T, None, pre, rtol, maxiter).X.T.to(B.dtype)
		ctx.save_for_backward(rtol if isinstance(rtol, torch.Tensor) else None, X, *tensors)
		ctx.rtol_float = rtol if not isinstance(rtol, torch.Tensor) else None
		return X

	@staticmethod
	def backward(ctx, Xbar):
		rtol_t, X, *tensors = ctx.saved_tensors
		rtol = rtol_t if rtol_t is not None else ctx.rtol_float
		op = ctx.op
		Bbar = _cg_loop(op.matmat_t, Xbar.T, None, ctx.pre, rtol, ctx.maxiter).X.T.to(Xbar.dtype)
		grads = [None] * len(tensors)
		want = [i for i, need in enumerate(ctx.needs_input_grad[5:]) if need]
		if want:
			with torch.enable_grad():
				out = op.matmat(X.detach())  # the saved output would lead autograd back into this node
				got = torch.autograd.grad(out, [tensors[i] for i in want], -Bbar, allow_unused=True)
			for i, g in zip(want, got):
				grads[i] = g
		return (None, None, None, None, Bbar if ctx.needs_input_grad[4] else None, *grads)


def _differentiable_solve(op, B, pre, rtol, maxiter):
	if op.dtype.is_complex:
		# As in the JAX package, a Hermitian solve is not differentiated (its
		# custom_linear_solve(symmetric=True) would transpose with conj(A)).
		if torch.is_grad_enabled() and any(t.requires_grad for t in (B, *op.float_tensors())):
			raise NotImplementedError("cg of a complex (Hermitian) operator is not differentiable")
		return _cg_loop(op.matmat_t, B.T, None, pre, rtol, maxiter).X.T.to(B.dtype)
	return _Solve.apply(op, pre, maxiter, rtol, B, *op.float_tensors())


def cg(
	A,
	B: torch.Tensor,
	X0: Optional[torch.Tensor] = None,
	rtol: float = 1e-6,
	maxiter: Optional[int] = None,
	precond: Union[str, torch.Tensor, NystromPreconditioner, DiagPreconditioner, None] = None,
	full: bool = False,
	precond_rank: int = 64,
	precond_seed=None,
	device="cuda",
):
	"""Solve ``A X = B`` for SPD ``A`` by (preconditioned) conjugate gradients
	(``primate_tpu/solvers.py:192-281``).

	``B`` may be a vector or an ``(n, k)`` block; all right-hand sides advance in one
	loop, one operator apply an iteration. ``precond``: ``"jacobi"`` (the diagonal of A:
	exact for dense and DIA operators and small CSR ones, otherwise estimated by
	:func:`~primate_tpu_torch.diag`), ``"nystrom"`` (rank ``precond_rank``, seeded by
	``precond_seed``), an explicit diagonal, or a prebuilt preconditioner.
	``maxiter`` defaults to ``min(10n, 10000)``. A warm start ``X0`` solves
	``A ΔX = B − A X0`` with each column's ``rtol`` rescaled so the stop is still
	``‖R‖ ≤ rtol·‖B‖``. A numpy ``A`` goes to ``device``; ``B`` goes to the operator's device.

	Returns ``X`` (the shape of ``B``), differentiable in ``B`` and in the operator's
	tensors; with ``full=True`` (no gradient) ``(X, iterations, residual_norms)``, the
	norms of the loop's recursively updated residuals, as the JAX package reports them
	(in float32 they drift from ``‖B − A X‖`` by rounding).
	"""
	op = aslinop(A, device=device)
	n = op.shape[0]
	B = torch.as_tensor(B, device=op.device).to(op.dtype)
	single = B.ndim == 1
	if single:
		B = B[:, None]
	maxiter = int(maxiter) if maxiter is not None else min(10 * n, 10_000)
	pre = _make_preconditioner(op, precond, precond_rank, precond_seed, _acc(B.dtype))

	if full:
		X0t = None if X0 is None else torch.as_tensor(X0, device=op.device).to(B.dtype).reshape(B.shape).T
		state = _cg_loop(op.matmat_t, B.T, X0t, pre, float(rtol), maxiter)
		X = state.X.T.to(B.dtype)
		res = torch.linalg.vector_norm(state.R, dim=1).cpu().numpy()
		return (X[:, 0] if single else X), state.it, (res[0] if single else res)

	if X0 is not None:
		# Warm start: the shifted system A·ΔX = B − A·X0 stops at ‖R‖ ≤ rtol·‖B‖, the
		# caller's target, by a per-column rtol rescaled by ‖B‖ / ‖B − A·X0‖.
		X0 = torch.as_tensor(X0, device=op.device).to(B.dtype).reshape(B.shape)
		Bs = B - op.matmat(X0)
		acc = _acc(B.dtype)
		nb = torch.linalg.vector_norm(B.detach().to(acc), dim=0)
		ns = torch.linalg.vector_norm(Bs.detach().to(acc), dim=0)
		rtol_eff = rtol * nb / torch.clamp_min(ns, torch.finfo(acc).tiny)
		X = X0 + _differentiable_solve(op, Bs, pre, rtol_eff, maxiter)
	else:
		X = _differentiable_solve(op, B, pre, float(rtol), maxiter)
	return X[:, 0] if single else X


def _make_preconditioner(op, precond, rank: int, seed, acc: torch.dtype):
	if precond is None or isinstance(precond, (NystromPreconditioner, DiagPreconditioner)):
		return precond
	if isinstance(precond, str) and precond == "nystrom":
		return nystrom_precond(op, rank=rank, seed=seed)
	if isinstance(precond, str):
		if precond != "jacobi":
			raise ValueError(f"Unknown preconditioner '{precond}'")
		d, d_stochastic = _operator_diagonal(op)
	else:
		# A caller's diagonal is trusted as exact; pass a floored one for noisy estimates.
		d, d_stochastic = torch.as_tensor(precond, device=op.device), False
	return DiagPreconditioner(_jacobi_weights(d.detach(), d_stochastic, acc))


def _jacobi_weights(d: torch.Tensor, stochastic: bool, acc: torch.dtype) -> torch.Tensor:
	"""Per-entry Jacobi weights ``1/d`` with a provenance-aware floor
	(``primate_tpu/solvers.py:299-319``): an exact diagonal keeps ``1/d`` down to an
	eps-relative positivity threshold; a stochastic estimate, which can come out
	tiny or ≤ 0, floors at ``1e-3·mean|d|``. Floored entries get the weight ``1/(1e-3·mean|d|)``."""
	d = torch.real(d)
	d_mean = torch.clamp_min(torch.mean(torch.abs(d)), torch.finfo(acc).tiny)
	rel_floor = 1e-3 if stochastic else float(torch.finfo(acc).eps)
	d_tiny = rel_floor * d_mean
	d_floor = 1e-3 * d_mean
	floored = d <= d_tiny
	_warn_floored_if_free(floored, d_floor)
	return torch.where(floored, 1.0 / d_floor, 1.0 / torch.maximum(d, d_tiny)).to(real_dtype(acc))


def _warn_floored_if_free(floored: torch.Tensor, d_floor: torch.Tensor) -> None:
	"""Warn that Jacobi flooring fired, but only for a CPU tensor: on the card the
	count would cost a device→host read per ``cg`` call."""
	if floored.device.type != "cpu":
		return
	n_floored = int(floored.sum())
	if n_floored:
		warnings.warn(
			f"jacobi preconditioner: {n_floored} non-positive/tiny diagonal "
			f"entr{'y' if n_floored == 1 else 'ies'} floored to weight 1/{float(d_floor):.3g} "
			"(stochastic diagonal estimate?)",
			stacklevel=4,
		)


def _operator_diagonal(op) -> tuple:
	"""``(diagonal, stochastic)``: exact extraction when cheap, else a stochastic
	estimate (``primate_tpu/solvers.py:349-369``; the flag drives the floor policy)."""
	from .operators.base import DenseOperator
	from .operators.sparse import CSROperator, DIAOperator

	if isinstance(op, DenseOperator):
		return torch.diagonal(op.A), False
	if isinstance(op, DIAOperator) and 0 in op.offsets:
		return op.bands[op.offsets.index(0)], False
	if isinstance(op, CSROperator) and op.shape[0] <= 4096:
		return torch.diagonal(op.todense()), False
	return _stochastic_diag(op), True


def _stochastic_diag(op) -> torch.Tensor:
	from .diagonal import diag

	with torch.no_grad():
		return torch.as_tensor(diag(op, converge="count", count=256, seed=0), device=op.device)


def solve(A, b: torch.Tensor, **kwargs) -> torch.Tensor:
	"""Alias for :func:`cg`: ``solve(A, b)`` reads naturally in GP losses."""
	return cg(A, b, **kwargs)
