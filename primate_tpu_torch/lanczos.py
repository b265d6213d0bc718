"""Block Lanczos tridiagonalization on probe-major blocks.

Counterpart of ``primate_tpu/lanczos.py``. All nv probes advance together; the
JAX ``lax.scan`` over ``deg`` steps becomes a Python loop that enqueues device
work and, but for selective re-orthogonalisation, never reads the device.

Without re-orthogonalisation (``orth=0``) on float32 or float64 each step is
``op.lanczos_sweep_step``: on a DIA operator on the card two kernels, carrying
the residuals unnormalised with their guarded divisors so that no pass
normalises. A sweep that returns its basis writes ``q = v / divisor`` (the
rounding pass A uses) into the basis window after pass B, and one that takes
``coeffs`` adds ``c_j·q_j`` to its running sum before each step; both are
PyTorch ops. With ``orth>0``, ``selective=True`` or a bfloat16 block (whose
``q_next`` the reference rounds to bfloat16 every step), each step calls
``op.lanczos_step(q_cur, q_prev, β)`` (on a DIA operator the stencil, β-axpy and
α kernel) and the rest (``v −= α·q``, the CGS window, β = ‖v‖, the done flags
and ``q_next``) stays in PyTorch. Selective re-orthogonalisation reads one flag
from the device per step, where the JAX package branches by ``lax.cond``.

Complex (Hermitian) operators (``primate_tpu/lanczos.py:223-227,298-316``): every
inner product conjugates its bra, α and β (the Jacobi matrix, the quadrature and
the sweep's state) are real, and the CGS window projects with ``conj(Q)``. On a
DIA operator each step is the complex ``dia_stencil_t`` kernel and PyTorch: the
step kernels are real only.
"""

from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .ops.dia import DIV_CUR, DONE, lanczos_state, row_sq_norm
from .random import real_dtype
from .tridiag import eigh_tridiag, eigvalsh_tridiag

__all__ = ["LanczosOutput", "lanczos_block", "lanczos_block_op", "lanczos", "rayleigh_ritz", "OrthogonalPolynomialBasis"]


class LanczosOutput(NamedTuple):
	"""alphas, betas: ``(deg, nv)``; ``betas[deg-1]`` is the final residual norm and the
	deg×deg tridiagonal uses ``betas[:deg-1]``. Q: ``(ncv, n, nv)`` window of basis
	vectors (slot ``t % ncv`` holds q_t; the whole basis when ``ncv == deg``), a view of
	the probe-major window. y: ``(..., n, nv)``, ``Σ_t coeffs[t]·q_t`` when ``coeffs``
	was given. reorth_steps: ``(deg,)`` bool, the steps selective re-orthogonalisation cleaned."""

	alphas: torch.Tensor
	betas: torch.Tensor
	Q: Optional[torch.Tensor] = None
	y: Optional[torch.Tensor] = None
	reorth_steps: Optional[torch.Tensor] = None


def _validate_params(n: int, deg: int, orth: int, ncv: Optional[int], return_basis: bool = False) -> Tuple[int, int, int]:
	"""Clamp (deg, orth, ncv) with the reference's rules (``primate_tpu/lanczos.py:60-71``)."""
	deg = int(np.clip(deg, 1, n))
	orth = deg if (orth < 0 or orth > deg) else int(orth)
	if ncv is None:
		ncv = deg if return_basis else int(np.clip(max(orth, 2), 2, deg))
	ncv = int(np.clip(ncv, min(2, deg), deg))
	# A window shorter than orth cannot hold it: clamp (reference `lanczos.py:13-16`).
	orth = min(orth, ncv)
	return deg, orth, ncv


def lanczos_block_op(
	op,
	V0: torch.Tensor,
	deg: int,
	ncv: int,
	orth: int = 0,
	rtol: float = 1e-8,
	reorth_passes: int = 2,
	return_basis: bool = True,
	coeffs: Optional[torch.Tensor] = None,
	basis_dtype=None,
	selective: bool = False,
	phys=None,
) -> LanczosOutput:
	"""Run ``deg`` Lanczos steps of ``op`` on the probe block ``V0 (n, nv)``
	(``primate_tpu/lanczos.py:74-201``).

	``ncv`` is the basis window's length; the last ``orth`` basis vectors in it
	are projected out of each new vector (``reorth_passes`` CGS passes). The
	window is kept when ``return_basis``, ``orth > 0`` or ``selective``, in
	``basis_dtype`` (default: ``V0``'s dtype). ``coeffs (deg, ..., nv)``
	accumulates ``y = Σ_t coeffs[t]·q_t`` in O(n·nv) memory: the second pass of
	two-pass f(A)v. ``selective=True`` replaces the fixed window by ω-monitored
	partial re-orthogonalisation (Simon 1984) against every written slot; use
	``ncv = deg``. ``phys`` chose the JAX package's halo-padded TPU carry, which
	has no counterpart here.
	"""
	from .operators.base import torch_dtype

	if phys is not None:
		raise NotImplementedError("phys= selects the TPU's halo-padded carry, which is not ported (the step kernels replace it)")
	deg, orth, ncv = _validate_params(V0.shape[0], deg, orth, ncv)
	return _lanczos_core(
		op, V0.T.contiguous(), deg=deg, ncv=ncv, orth=orth, rtol=rtol, reorth_passes=reorth_passes,
		return_basis=return_basis, coeffs=coeffs, basis_dtype=torch_dtype(basis_dtype), selective=selective,
	)


def lanczos_block(
	matmat: Callable[[torch.Tensor], torch.Tensor],
	V0: torch.Tensor,
	deg: int,
	ncv: int,
	orth: int = 0,
	rtol: float = 1e-8,
	reorth_passes: int = 2,
	return_basis: bool = True,
	coeffs: Optional[torch.Tensor] = None,
	basis_dtype=None,
	matmat_t: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
	selective: bool = False,
) -> LanczosOutput:
	"""``deg`` Lanczos steps of the symmetric operator that ``matmat`` applies to ``(n, k)``
	blocks, on the probe block ``V0 (n, nv)`` (``primate_tpu/lanczos.py:146-201``): the pure
	function behind :func:`lanczos_block_op`, with the same keywords. ``matmat_t``, the
	probe-major apply ``(k, n) → (k, n)``, is used where given (the sweep carries its
	blocks probe-major); else each step transposes around ``matmat``."""
	from .operators.base import FunctionOperator

	op = FunctionOperator(matmat, (V0.shape[0], V0.shape[0]), dtype=V0.dtype, device=V0.device)
	if matmat_t is not None:
		op.matmat_t = matmat_t
	return lanczos_block_op(
		op, V0, deg=deg, ncv=ncv, orth=orth, rtol=rtol, reorth_passes=reorth_passes,
		return_basis=return_basis, coeffs=coeffs, basis_dtype=basis_dtype, selective=selective,
	)


def _lanczos_core(
	op, V0t: torch.Tensor, *, deg: int, ncv: int, orth: int, rtol: float, reorth_passes: int, return_basis: bool = False,
	coeffs: Optional[torch.Tensor] = None, basis_dtype=None, selective: bool = False,
) -> LanczosOutput:
	nv, n = V0t.shape
	dtype, device = V0t.dtype, V0t.device
	if torch.is_grad_enabled() and any(t.requires_grad for t in getattr(op, "float_tensors", tuple)()):
		# The sweep updates its state in place and its step kernels have no backward.
		raise NotImplementedError(
			"reverse mode through the Lanczos recurrence is not ported: differentiate a spectral sum with "
			"autodiff.spectral_sum (or hutch(..., differentiable=True)), or run the sweep under torch.no_grad()"
		)
	acc = torch.promote_types(dtype, torch.float32)  # f32 accumulation for bf16 storage
	r_acc = real_dtype(acc)  # α, β and the sweep's state: real for Hermitian operators too
	b_dtype = basis_dtype or dtype
	keep_window = return_basis or orth > 0 or selective

	norm0 = torch.sqrt(row_sq_norm(V0t.to(acc)))
	q0 = (V0t / torch.where(norm0 > 0, norm0, 1)[:, None].to(dtype)).to(dtype)
	residual_tol = float(np.sqrt(n) * rtol)
	alphas = torch.empty((deg, nv), dtype=r_acc, device=device)
	betas = torch.empty((deg, nv), dtype=r_acc, device=device)
	Q_win = None
	if keep_window:
		Q_win = torch.zeros((ncv, nv, n), dtype=b_dtype, device=device)
		Q_win[0] = q0
	y = None
	if coeffs is not None:
		coeffs = torch.as_tensor(coeffs, device=device)
		coeffs = coeffs.to(acc if coeffs.is_complex() else r_acc)  # real coefficients stay real
		y = torch.zeros(coeffs.shape[1:] + (n,), dtype=acc, device=device)  # (..., nv, n)

	def output(reorth_steps=None) -> LanczosOutput:
		return LanczosOutput(
			alphas=alphas,
			betas=betas,
			Q=Q_win.permute(0, 2, 1) if keep_window else None,
			y=y.transpose(-1, -2) if y is not None else None,
			reorth_steps=reorth_steps,
		)

	def write_slot(j: int, q_next: torch.Tensor, advance) -> None:
		# The basis keeps a probe's last valid vector once it is done (reference
		# zero-fill semantics); a window kept only to re-orthogonalise takes q_next,
		# which is exactly 0 for a done probe.
		slot = (j + 1) % ncv
		if not return_basis:
			Q_win[slot] = q_next
		elif j + 1 < deg:
			Q_win[slot] = torch.where(advance[:, None], q_next.to(b_dtype), Q_win[slot])

	if orth == 0 and not selective and dtype == acc:
		state = lanczos_state(nv, r_acc, device)
		v_prev, v_cur = torch.zeros((nv, n), dtype=acc, device=device), q0
		for j in range(deg):
			if y is not None:
				y.addcmul_(coeffs[j][..., None], v_cur / state.scal[DIV_CUR][:, None])
			v_prev, v_cur = v_cur, op.lanczos_sweep_step(v_cur, v_prev, state, alphas[j], betas[j], residual_tol)
			if return_basis:
				write_slot(j, v_cur / state.scal[DIV_CUR][:, None], state.scal[DONE] == 0)
		return output()

	# Re-orthogonalisation, or a storage dtype narrower than the accumulation
	# (bfloat16): q_next is rounded to the storage dtype every step, as in JAX
	# (``primate_tpu/lanczos.py:388``), which the unnormalised carry above cannot do.
	slot_ids = torch.arange(ncv, device=device)

	def _cgs_window(v, valid):
		# Broadcast products and sums over n, not matmuls: no contraction of
		# this sweep goes through torch.matmul, so TF32 never comes into it. A
		# later change that puts a matmul here must pin float32 precision.
		Q_bra = Q_win.conj() if Q_win.is_complex() else Q_win
		for _ in range(max(1, reorth_passes)):
			proj = torch.sum(Q_bra * v[None, :, :], dim=2) * valid[:, None]
			v = v - torch.sum(Q_win * proj[:, :, None].to(acc), dim=0)
		return v

	if selective:
		eps = torch.finfo(r_acc).eps
		eps_noise, sel_tol = eps * float(np.sqrt(n)), float(np.sqrt(eps))
		om_pp = torch.zeros((nv, ncv), dtype=r_acc, device=device)
		om_p = torch.zeros((nv, ncv), dtype=r_acc, device=device)
		om_p[:, 0] = 1.0
		a_win = torch.zeros((nv, ncv), dtype=r_acc, device=device)
		b_win = torch.zeros((nv, ncv), dtype=r_acc, device=device)
		force, triggers = False, []

	q_prev, q_cur = torch.zeros((nv, n), dtype=dtype, device=device), q0
	beta_j = torch.zeros(nv, dtype=r_acc, device=device)
	done = torch.zeros(nv, dtype=torch.bool, device=device)
	for j in range(deg):
		if y is not None:
			y.addcmul_(coeffs[j][..., None], q_cur.to(acc))
		v, alpha_j = op.lanczos_step(q_cur, q_prev, beta_j)
		v.addcmul_(alpha_j[:, None], q_cur.to(acc), value=-1)  # in place: v is a fresh tensor
		if selective:
			# Simon's ω-recurrence (``primate_tpu/lanczos.py:318-362``): ω[t] estimates
			# ⟨q_{j+1}, q_t⟩ per window slot in O(ncv·nv); a breach of √eps cleans this
			# vector and the next against every written slot.
			beta_est = torch.sqrt(row_sq_norm(v))
			slot_j = j % ncv
			a_win[:, slot_j] = alpha_j
			b_win[:, slot_j] = beta_j
			num = (
				torch.roll(b_win, -1, 1) * torch.roll(om_p, -1, 1) + (a_win - alpha_j[:, None]) * om_p
				+ b_win * torch.roll(om_p, 1, 1) - beta_j[:, None] * om_pp
			)
			om_next = num / torch.where(beta_est > 0, beta_est, torch.inf)[:, None]
			om_next = torch.where(om_next >= 0, om_next + eps_noise, om_next - eps_noise)
			age_next = (j + 1 - slot_ids) % ncv
			tracked = (age_next <= j + 1) & (age_next >= 2)
			om_next = torch.where(tracked[None, :], om_next, 0.0)
			om_next[:, slot_j] = eps_noise
			om_next[:, (j + 1) % ncv] = 1.0
			live = torch.abs(om_next) * (~done)[:, None].to(r_acc)
			breach = bool(torch.any(live * tracked[None, :].to(r_acc) > sel_tol))  # one device read a step
			trigger = breach or force
			if trigger:
				v = _cgs_window(v, (((j - slot_ids) % ncv) <= j).to(r_acc))
				om_next = torch.where(tracked[None, :], torch.sign(om_next) * eps_noise, om_next)
				om_p = torch.where((slot_ids != slot_j)[None, :], torch.sign(om_p) * eps_noise, om_p)
			om_pp, om_p, force = om_p, om_next, breach
			triggers.append(trigger)
		elif orth > 0:
			age = (j - slot_ids) % ncv
			v = _cgs_window(v, ((age < orth) & (age <= j)).to(r_acc))
		beta_next = torch.sqrt(row_sq_norm(v))
		newly_done = beta_next < residual_tol
		alphas[j] = torch.where(done, 0.0, alpha_j)
		betas[j] = torch.where(done, 0.0, beta_next)
		# Guarded divide: once β vanishes, q_next = 0 and the recurrence
		# self-extinguishes, so α/β emit zeros after breakdown as in JAX.
		q_next = v.div_(torch.where(beta_next > residual_tol, beta_next, torch.inf)[:, None]).to(dtype)
		if keep_window:
			write_slot(j, q_next.to(b_dtype), ~(done | newly_done))
		q_prev, q_cur, beta_j, done = q_cur, q_next, beta_next, done | newly_done
	return output(torch.tensor(triggers, dtype=torch.bool) if selective else None)


def lanczos(
	A,
	v0=None,
	deg: Optional[int] = None,
	rtol: float = 1e-8,
	orth: int = 0,
	sparse_mat: bool = False,
	return_basis: bool = False,
	seed=None,
	dtype=None,
	ncv: Optional[int] = None,
	reorth_passes: int = 2,
	basis_dtype=None,
	selective: bool = False,
	device="cuda",
) -> tuple:
	r"""Lanczos tridiagonalization ``T = Qᵀ A Q`` of a symmetric operator (``primate_tpu/lanczos.py:418-518``).

	``deg`` steps with ``orth`` re-orthogonalisations per step (0 none, ``deg`` or
	negative full). ``v0 (n,)`` gives reference-shaped outputs, a block
	``v0 (n, nv)`` runs all its probes in one sweep; without ``v0`` one start
	vector is drawn uniform in [-1, 1] from ``seed``. Returns ``(a, b)``: the
	diagonal ``(deg,)`` and off-diagonal ``(deg-1,)`` (with a trailing probe axis
	for a block), in the accumulation dtype; with ``return_basis=True`` also
	``Q``, ``(n, ncv)`` for one vector and ``(nv, n, ncv)`` for a block, in natural
	order; with ``sparse_mat=True`` the tridiagonal matrix in place of ``(a, b)``.
	``selective=True`` (implies ``ncv = deg``) is ω-monitored partial
	re-orthogonalisation. ``device`` is where a numpy or scipy ``A`` goes.
	"""
	from .operators.base import aslinop, torch_dtype
	from .random import real_dtype
	from .trace import _base_seed, batch_generator

	op = aslinop(A, dtype=dtype, device=device)
	n = op.shape[0]
	deg = n if deg is None else min(int(deg), n)
	if deg <= 0:
		raise ValueError("Number of steps must be positive!")
	if selective:
		ncv = deg  # the ω slots are window-cyclic: a short window would track the wrong vectors
	deg, orth, ncv = _validate_params(n, deg, orth, ncv, return_basis)
	f_dtype = torch_dtype(dtype) or op.dtype
	if v0 is None:
		g = batch_generator(_base_seed(seed), 0, op.device)
		v0 = torch.rand(n, generator=g, device=op.device, dtype=real_dtype(f_dtype)) * 2 - 1
	v0 = torch.as_tensor(v0, dtype=f_dtype, device=op.device)
	single = v0.ndim == 1
	if single:
		v0 = v0[:, None]
	if v0.shape[0] != n:
		raise ValueError("Invalid starting vector; must match the number of columns of A.")
	out = lanczos_block_op(
		op, v0, deg=deg, ncv=ncv, orth=orth, rtol=rtol, reorth_passes=reorth_passes,
		return_basis=return_basis, basis_dtype=basis_dtype, selective=selective,
	)
	a, b = out.alphas, out.betas[: deg - 1]
	Q = None
	if return_basis:
		# Slot s holds q_t with t ≡ s (mod ncv): the last ncv vectors start at slot deg % ncv.
		Qw = torch.roll(out.Q, -(deg % ncv), 0) if ncv < deg else out.Q
		Q = torch.movedim(Qw, 0, -1)  # (n, nv, ncv)
	if single:
		a, b = a[:, 0], b[:, 0]
		Q = Q[:, 0, :] if Q is not None else None
	elif Q is not None:
		Q = torch.movedim(Q, 1, 0)  # (nv, n, ncv)
	if sparse_mat:
		T = _tridiag_matrix(a, b)
		return T if not return_basis else (T, Q)
	return (a, b) if not return_basis else ((a, b), Q)


def _tridiag_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
	"""Densify Jacobi coefficients ``(deg[, nv])``, ``(deg-1[, nv])`` into ``([nv,] deg, deg)`` tridiagonals."""
	a = torch.atleast_2d(a.T if a.ndim == 2 else a)
	b = torch.atleast_2d(b.T if b.ndim == 2 else b)
	T = torch.diag_embed(a) + torch.diag_embed(b, offset=1) + torch.diag_embed(b, offset=-1)
	return T[0] if T.shape[0] == 1 else T


def rayleigh_ritz(A, deg: Optional[int] = None, return_eigenvectors: bool = False, method: str = "auto", **kwargs):
	"""Ritz values by Lanczos and a tridiagonal eigensolve (``primate_tpu/lanczos.py:529-559``).

	``method`` picks the eigensolver ("auto"/"eigh" batched ``torch.linalg.eigh``,
	"tqli" the implicit-shift QL). The other keywords go to :func:`lanczos`
	(``return_basis=True`` appends the basis to the result)."""
	n = A.shape[0]
	deg = n if deg is None else min(int(deg), n)
	deg = int(np.clip(deg, 2, n))
	Q_basis = kwargs.pop("return_basis", False)
	if Q_basis:
		(a, b), Q = lanczos(A, deg=deg, return_basis=True, **kwargs)
	else:
		a, b = lanczos(A, deg=deg, return_basis=False, **kwargs)
	if a.ndim == 2:  # a block: probes leading for the eigensolvers
		a, b = a.T, b.T
	if return_eigenvectors:
		rw, Y = eigh_tridiag(a, b, method=method)
		return (rw, Y) if not Q_basis else (rw, Y, Q)
	rw = eigvalsh_tridiag(a, b, method=method)
	return rw if not Q_basis else (rw, Q)


class OrthogonalPolynomialBasis:
	r"""The orthonormal polynomial basis of the spectral measure ψ(·; A, v)
	(``primate_tpu/lanczos.py:562-664``).

	Built from an operator (a Lanczos sweep; keywords go to :func:`lanczos`) or
	from coefficients. ``betas_kind`` labels a ``(deg,)`` betas array: "leading"
	(``b[0]`` unused) or "trailing" (``β_1 … β_deg``, the sweep's raw output);
	"auto"/"offdiag" take the ``(deg-1,)`` off-diagonal. An early-terminated sweep
	(β ≈ 0) truncates the basis to the polynomials that exist.
	"""

	def __init__(self, A=None, deg: Optional[int] = None, *, alphas=None, betas=None, mu_0: float = 1.0,
		betas_kind: str = "auto", **kwargs):
		if A is not None:
			if alphas is not None or betas is not None:
				raise ValueError("Pass either an operator or coefficients, not both")
			alphas, betas = lanczos(A, deg=deg, **kwargs)
		if alphas is None or betas is None:
			raise ValueError("Need an operator or (alphas, betas)")
		self.alphas = torch.as_tensor(alphas)
		if self.alphas.ndim != 1:
			raise ValueError("Batched coefficient sets not supported; construct one basis per probe")
		b = torch.as_tensor(betas, device=self.alphas.device)
		k = self.alphas.shape[-1]
		zero = torch.zeros_like(b[..., :1])
		if betas_kind in ("auto", "offdiag"):
			if b.shape[-1] != k - 1:
				raise ValueError(
					f"betas of length {b.shape[-1]} with {k} alphas is ambiguous; pass the (deg-1,) off-diagonals "
					"(lanczos() output), or set betas_kind='leading' (b[0] unused) or 'trailing' (β_1..β_deg)"
				)
			b = torch.cat([zero, b], dim=-1)
		elif betas_kind == "leading":
			if b.shape[-1] != k:
				raise ValueError(f"leading-slot betas must have length deg={k}")
		elif betas_kind == "trailing":
			if b.shape[-1] != k:
				raise ValueError(f"trailing betas must have length deg={k}")
			b = torch.cat([zero, b[..., : k - 1]], dim=-1)
		else:
			raise ValueError(f"Unknown betas_kind {betas_kind!r}; use 'auto'|'offdiag'|'leading'|'trailing'")
		b_np = b.detach().cpu().double().numpy()
		scale = max(float(np.abs(self.alphas.detach().cpu().double().numpy()).max(initial=0.0)),
			float(np.abs(b_np).max(initial=0.0)), 1.0)
		tiny = np.abs(b_np[1:]) <= 1e-12 * scale
		if tiny.any():
			keep = int(np.argmax(tiny)) + 1  # p_0 … p_{keep-1}
			self.alphas, b = self.alphas[:keep], b[:keep]
		self.betas = b
		self.mu_0 = float(mu_0)

	@property
	def deg(self) -> int:
		return int(self.alphas.shape[-1])

	def __len__(self) -> int:
		return self.deg

	def __call__(self, x) -> torch.Tensor:
		"""``[p_0(x), …, p_{deg-1}(x)]`` → shape ``x.shape + (deg,)``."""
		from .fttr import ortho_poly

		return ortho_poly(x, 1.0 / np.sqrt(self.mu_0), self.alphas, self.betas)

	def jacobi_matrix(self) -> torch.Tensor:
		return _tridiag_matrix(self.alphas, self.betas[1:])

	def gauss_quadrature(self, quad: str = "gw"):
		"""Nodes and weights of the deg-point Gauss rule for ψ (weights × mu_0)."""
		from .integrate import quadrature

		theta, tau = quadrature(self.alphas, self.betas[1:], quad=quad)
		return theta, tau * self.mu_0
