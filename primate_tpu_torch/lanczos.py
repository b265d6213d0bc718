"""Block Lanczos tridiagonalization on probe-major blocks.

Counterpart of ``primate_tpu/lanczos.py``. All nv probes advance together; the
JAX ``lax.scan`` over ``deg`` steps becomes a Python loop that enqueues device
work and, but for selective re-orthogonalisation, never reads the device.

Without re-orthogonalisation (``orth=0``) on float32, float64, complex64 or complex128 each step is
``op.lanczos_sweep_step``: on a DIA operator on the card two kernels, carrying
the residuals unnormalised with their guarded divisors so that no pass
normalises. A sweep that returns its basis writes ``q = v / divisor`` (the
rounding pass A uses) into the basis window after pass B, and one that takes
``coeffs`` adds ``c_j·q_j`` to its running sum before each step; both are
PyTorch ops. A step may leave its finish (α, β, the state) pending, as a row-sharded DIA
operator's does for the next step's pass A; the sweep calls ``op.lanczos_sweep_flush``
before it reads the state between steps (the basis, ``coeffs``) and at its end. A bfloat16
block without re-orthogonalisation (whose ``q_next`` the reference rounds to bfloat16 every
step) takes ``op.lanczos_round_step`` a step: on a DIA operator on the card pass A's bf16
instantiation (``w`` and α in float32) and the round pair (β', the done flags and ``q_next``
rounded to bf16), three kernels; on any other operator ``op.lanczos_step`` and the same
arithmetic as PyTorch ops. With ``orth>0`` or ``selective=True``, each step calls ``op.lanczos_step(q_cur, q_prev, β)``
(on a DIA operator pass A), then the CGS window (:class:`~primate_tpu_torch.ops.cgs.CgsWindow`:
``v −= α·q``, the passes against the valid slots, Σ|v|²; on the card a chain of kernels that reads
each valid slot once a pass, on the CPU PyTorch ops); β, the done flags and ``q_next = v / β`` stay
PyTorch ops. Selective re-orthogonalisation reads one flag from the device per step, where the JAX
package branches by ``lax.cond``.

Reverse mode (``jax.grad`` through the JAX package's ``lax.scan``): while grad mode is on and
the start block, the coefficients or a tensor of the operator requires a gradient, the sweep runs
out of place (:func:`_lanczos_core_ad`): each step's apply through ``op.matmat_t`` (the kernels'
autograd Functions), α, β, the guarded divisors and the CGS window as PyTorch ops that write
nothing in place, the window a list of blocks. No step kernel runs there; every other sweep is
the in-place one above, unchanged.

Row-sharded operators (:mod:`~primate_tpu_torch.parallel`): ``op.sweep_rows(nv)`` gives what the
sweep carries and how it finishes a sum over n. For an unsharded operator that is the whole block
and local sums (:class:`~primate_tpu_torch.operators.base.WholeRows`), or with ``phys=True`` the
block in a DIA operator's padded carry (:class:`~primate_tpu_torch.operators.base.PaddedRows`); a
sharded operator carries its rank's rows (and probe slice) in a buffer with halo columns (a sharded DIA
operator: the padded carry, on which its steps run the step kernels), and the sums (‖v₀‖, α and β of each
step, ‖v‖, the CGS window's projections and selective re-orthogonalisation's β estimate) are finished
by an all-reduce over its op group; the outputs (α, β, the basis, ``y``) are gathered at the end, and
the breakdown tolerance and ω's noise floor use the global n. The out-of-place sweep uses the
operator's replicated ``matmat_t`` instead.

Complex (Hermitian) operators (``primate_tpu/lanczos.py:223-227,298-316``): every
inner product conjugates its bra, α and β (the Jacobi matrix, the quadrature and
the sweep's state) are real, and the CGS window projects with ``conj(Q)``. On a
DIA operator the step kernels take complex64/complex128 carries as they take real
ones (passes A and B a step at ``orth=0``, pass A at ``orth>0``), with a real state;
the padded carry (``phys=True``) and the row-sharded sweep stay real only.
"""

from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .ops.cgs import CgsWindow, slot_mask
from .ops.dia import DIV_CUR, DONE, lanczos_state, row_sq_norm
from .random import real_dtype
from .tridiag import eigh_tridiag, eigvalsh_tridiag
from .utils.profiling import annotate

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


# The dtypes a sweep may keep its basis window in (``basis_dtype``): a real sweep's any real floating width, a
# complex sweep's either complex width. A real window would drop a complex basis's imaginary parts, and a complex
# one cannot update a real carry; the CGS window's kernels (``ops.cgs.COMBOS``) take every pair these allow.
_REAL_BASES = (torch.float16, torch.bfloat16, torch.float32, torch.float64)
_COMPLEX_BASES = (torch.complex64, torch.complex128)


def _basis_dtype(basis_dtype: Optional[torch.dtype], dtype: torch.dtype) -> torch.dtype:
	"""The basis window's dtype: ``basis_dtype``, by default the sweep's ``dtype``. ``TypeError`` where it is not of
	the sweep's kind (:data:`_REAL_BASES` for a real sweep, :data:`_COMPLEX_BASES` for a complex one), on every device."""
	b_dtype = basis_dtype or dtype
	takes = _COMPLEX_BASES if dtype.is_complex else _REAL_BASES
	if b_dtype not in takes:
		names = ", ".join(str(t).replace("torch.", "") for t in takes)
		raise TypeError(f"basis_dtype must be one of {names} for a {str(dtype).replace('torch.', '')} sweep; got {b_dtype}")
	return b_dtype


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
	``basis_dtype`` (default: ``V0``'s dtype): float16, bfloat16, float32 or float64
	for a real sweep, complex64 or complex128 for a complex one; any other raises
	``TypeError`` on every device (the JAX package casts to any, and a real window
	would drop a complex basis's imaginary parts). ``coeffs (deg, ..., nv)``
	accumulates ``y = Σ_t coeffs[t]·q_t`` in O(n·nv) memory: the second pass of
	two-pass f(A)v. ``selective=True`` replaces the fixed window by ω-monitored
	partial re-orthogonalisation (Simon 1984) against every written slot; use
	``ncv = deg``. ``phys=True`` carries the sweep in the operator's halo-padded layout
	(``DIAOperator.carry_spec``, the counterpart of JAX's ``phys_spec``): ``(nv, ld)``
	blocks with the rows at ``[lo, lo + n)`` and zero margins, on which the step kernels
	run as on the flat carry; α, β, the basis and ``y`` match the flat sweep to round-off.
	It raises ``ValueError`` on an operator without that layout (not DIA, complex, or
	rectangular), where JAX warns and runs flat. ``False`` and ``None`` carry the flat
	``(nv, n)`` blocks (JAX's ``None`` engages the padded carry only on a ``use_pallas``
	operator, a TPU switch the port has no counterpart of). A sweep that differentiates
	(:func:`_lanczos_core_ad`) carries flat blocks either way.
	"""
	from .operators.base import torch_dtype

	deg, orth, ncv = _validate_params(V0.shape[0], deg, orth, ncv)
	with annotate("primate.sweep"):
		return _lanczos_core(
			op, V0.T.contiguous(), deg=deg, ncv=ncv, orth=orth, rtol=rtol, reorth_passes=reorth_passes,
			return_basis=return_basis, coeffs=coeffs, basis_dtype=torch_dtype(basis_dtype), selective=selective,
			phys=phys is True,
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
	coeffs: Optional[torch.Tensor] = None, basis_dtype=None, selective: bool = False, phys: bool = False,
) -> LanczosOutput:
	nv, n = V0t.shape
	dtype, device = V0t.dtype, V0t.device
	b_dtype = _basis_dtype(basis_dtype, dtype)
	# The rows the sweep carries and how it finishes a sum over n: the whole block and local sums,
	# the block in a padded carry (phys), or a row-sharded operator's rank's rows (and probe slice),
	# each sum over its op group.
	layout = op.sweep_rows(nv, split_probes=not selective, phys=phys)
	if _needs_grad(op, V0t, coeffs):
		return _lanczos_core_ad(
			op, V0t, deg=deg, ncv=ncv, orth=orth, rtol=rtol, reorth_passes=reorth_passes, return_basis=return_basis,
			coeffs=coeffs, basis_dtype=b_dtype, selective=selective,
		)
	acc = torch.promote_types(dtype, torch.float32)  # f32 accumulation for bf16 storage
	r_acc = real_dtype(acc)  # α, β and the sweep's state: real for Hermitian operators too
	keep_window = return_basis or orth > 0 or selective
	rows, reduce = layout.rows, layout.reduce_rows

	X0 = layout.carry(V0t)
	nv_l, n_l = rows(X0).shape
	norm0 = torch.sqrt(reduce(row_sq_norm(rows(X0).to(acc))))
	q0 = (X0 / torch.where(norm0 > 0, norm0, 1)[:, None].to(dtype)).to(dtype)
	residual_tol = float(np.sqrt(n) * rtol)
	alphas = torch.empty((deg, nv_l), dtype=r_acc, device=device)
	betas = torch.empty((deg, nv_l), dtype=r_acc, device=device)
	Q_win = None
	if keep_window:
		Q_win = torch.zeros((ncv, nv_l, n_l), dtype=b_dtype, device=device)
		Q_win[0] = rows(q0)
	y = None
	if coeffs is not None:
		coeffs = layout.probes(torch.as_tensor(coeffs, device=device))
		coeffs = coeffs.to(acc if coeffs.is_complex() else r_acc)  # real coefficients stay real
		y = torch.zeros(coeffs.shape[1:] + (n_l,), dtype=acc, device=device)  # (..., nv, n)

	def output(reorth_steps=None) -> LanczosOutput:
		return LanczosOutput(
			alphas=layout.gather_probes(alphas),
			betas=layout.gather_probes(betas),
			Q=layout.gather_rows(Q_win).permute(0, 2, 1) if keep_window else None,
			y=layout.gather_rows(y).transpose(-1, -2) if y is not None else None,
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
		state = lanczos_state(nv_l, r_acc, device)
		v_prev, v_cur = torch.zeros_like(q0), q0
		for j in range(deg):
			if y is not None:
				op.lanczos_sweep_flush(state)  # the divisor is read here
				y.addcmul_(coeffs[j][..., None], rows(v_cur) / state.scal[DIV_CUR][:, None])
			v_prev, v_cur = v_cur, op.lanczos_sweep_step(v_cur, v_prev, state, alphas[j], betas[j], residual_tol, layout=layout)
			if return_basis:
				op.lanczos_sweep_flush(state)
				write_slot(j, rows(v_cur) / state.scal[DIV_CUR][:, None], state.scal[DONE] == 0)
		op.lanczos_sweep_flush(state)  # before α and β are read
		return output()

	# A storage dtype narrower than the accumulation (bfloat16): q_next is rounded to the
	# storage dtype every step, as in JAX (``primate_tpu/lanczos.py:388``), which the
	# unnormalised carry above cannot do. Each step is ``op.lanczos_round_step``: pass A and
	# the rest of the step (on a DIA operator on the card three kernels), the state as above.
	if orth == 0 and not selective:
		state = lanczos_state(nv_l, r_acc, device)
		q_prev, q_cur = torch.zeros_like(q0), q0
		for j in range(deg):
			if y is not None:
				y.addcmul_(coeffs[j][..., None], rows(q_cur).to(acc))
			q_prev, q_cur = q_cur, op.lanczos_round_step(q_cur, q_prev, state, alphas[j], betas[j], residual_tol, layout=layout)
			if keep_window:
				write_slot(j, rows(q_cur).to(b_dtype), state.scal[DONE] == 0)
		return output()

	# Re-orthogonalisation: each step is ``op.lanczos_step``, then the rest of the step up to β (``v −= α·q``,
	# the CGS window, Σ|v|²) in place on the rank's rows of the fresh block v: on the card a chain of kernels,
	# on the CPU PyTorch ops (``ops.cgs``). The window's slot j % ncv holds q_j exactly where it stores the
	# sweep's dtype and is not a returned basis (which keeps a finished probe's last vector): the α step reads
	# q_j there (the slot is named, not handed as rows).
	window = CgsWindow(Q_win, reduce)
	q_in_window = b_dtype == dtype and not return_basis
	if selective:
		omega = _Omega(nv_l, ncv, n, r_acc, device)

	q_prev, q_cur = torch.zeros_like(q0), q0
	beta_j = torch.zeros(nv_l, dtype=r_acc, device=device)
	done = torch.zeros(nv_l, dtype=torch.bool, device=device)
	for j in range(deg):
		if y is not None:
			y.addcmul_(coeffs[j][..., None], rows(q_cur).to(acc))
		v, alpha_j = op.lanczos_step(q_cur, q_prev, beta_j, layout=layout)
		# The chain's kernels read v's rows and α packed: a plain step hands v column-major where matmat_t is a
		# transpose around matmat, and a complex α as the real view of a complex sum.
		v, alpha_j = v.contiguous(), alpha_j.contiguous()
		v_rows = rows(v)
		q_j, slot_j = (None, j % ncv) if q_in_window else (rows(q_cur), -1)
		if selective:
			sq = window(v_rows, 0, reorth_passes, alpha_j, q_j, slot_j)
			trigger = omega.breach(j, alpha_j, beta_j, sq, done)  # one device read a step
			if trigger:
				sq = window(v_rows, slot_mask(j, orth, ncv, selective=True), reorth_passes)
			omega.advance(j, trigger)
		else:
			sq = window(v_rows, slot_mask(j, orth, ncv), reorth_passes, alpha_j, q_j, slot_j)
		beta_next = torch.sqrt(sq)
		newly_done = beta_next < residual_tol
		alphas[j] = torch.where(done, 0.0, alpha_j)
		betas[j] = torch.where(done, 0.0, beta_next)
		# Guarded divide: once β vanishes, q_next = 0 and the recurrence
		# self-extinguishes, so α/β emit zeros after breakdown as in JAX.
		q_next = v.div_(torch.where(beta_next > residual_tol, beta_next, torch.inf)[:, None]).to(dtype)
		if keep_window:
			write_slot(j, rows(q_next).to(b_dtype), ~(done | newly_done))
		q_prev, q_cur, beta_j, done = q_cur, q_next, beta_next, done | newly_done
	return output(torch.tensor(omega.triggers, dtype=torch.bool) if selective else None)


class _Omega:
	"""Simon's ω-recurrence of selective re-orthogonalisation (``primate_tpu/lanczos.py:318-362``):
	ω[t] estimates ⟨q_{j+1}, q_t⟩ per window slot in O(ncv·nv); a breach of √eps cleans this
	vector and the next against every written slot. It decides only when to clean, so the
	out-of-place sweep feeds it detached values."""

	def __init__(self, nv: int, ncv: int, n: int, r_acc: torch.dtype, device):
		eps = torch.finfo(r_acc).eps
		self.ncv, self.r_acc = ncv, r_acc
		self.eps_noise, self.sel_tol = eps * float(np.sqrt(n)), float(np.sqrt(eps))
		self.slot_ids = torch.arange(ncv, device=device)
		self.om_pp = torch.zeros((nv, ncv), dtype=r_acc, device=device)
		self.om_p = torch.zeros((nv, ncv), dtype=r_acc, device=device)
		self.om_p[:, 0] = 1.0
		self.a_win = torch.zeros((nv, ncv), dtype=r_acc, device=device)
		self.b_win = torch.zeros((nv, ncv), dtype=r_acc, device=device)
		self.force, self.triggers = False, []

	def breach(self, j: int, alpha_j, beta_j, sq, done) -> bool:
		"""Advance ω to level j + 1 from step j's α, β and ``sq``, the residual's Σ|v|² finished over n;
		whether to clean the residual."""
		ncv, r_acc, eps_noise = self.ncv, self.r_acc, self.eps_noise
		om_p, om_pp, a_win, b_win = self.om_p, self.om_pp, self.a_win, self.b_win
		beta_est = torch.sqrt(sq)
		slot_j = j % ncv
		a_win[:, slot_j] = alpha_j
		b_win[:, slot_j] = beta_j
		num = (
			torch.roll(b_win, -1, 1) * torch.roll(om_p, -1, 1) + (a_win - alpha_j[:, None]) * om_p
			+ b_win * torch.roll(om_p, 1, 1) - beta_j[:, None] * om_pp
		)
		om_next = num / torch.where(beta_est > 0, beta_est, torch.inf)[:, None]
		om_next = torch.where(om_next >= 0, om_next + eps_noise, om_next - eps_noise)
		age_next = (j + 1 - self.slot_ids) % ncv
		self.tracked = (age_next <= j + 1) & (age_next >= 2)
		om_next = torch.where(self.tracked[None, :], om_next, 0.0)
		om_next[:, slot_j] = eps_noise
		om_next[:, (j + 1) % ncv] = 1.0
		self.om_next = om_next
		live = torch.abs(om_next) * (~done)[:, None].to(r_acc)
		self.breached = bool(torch.any(live * self.tracked[None, :].to(r_acc) > self.sel_tol))
		return self.breached or self.force

	def advance(self, j: int, cleaned: bool) -> None:
		"""Floor both carried levels after a cleaning pass, and shift them."""
		om_next, om_p = self.om_next, self.om_p
		if cleaned:
			om_next = torch.where(self.tracked[None, :], torch.sign(om_next) * self.eps_noise, om_next)
			om_p = torch.where((self.slot_ids != j % self.ncv)[None, :], torch.sign(om_p) * self.eps_noise, om_p)
		self.om_pp, self.om_p, self.force = om_p, om_next, self.breached
		self.triggers.append(cleaned)


def _needs_grad(op, V0t: torch.Tensor, coeffs) -> bool:
	"""Whether autograd must reach through the sweep: grad mode is on and the start block, the
	coefficients or a tensor the operator's applies read requires a gradient."""
	if not torch.is_grad_enabled():
		return False
	found = [V0t, *getattr(op, "float_tensors", tuple)()]
	if isinstance(coeffs, torch.Tensor):
		found.append(coeffs)
	return any(t.requires_grad for t in found)


def _lanczos_core_ad(
	op, V0t: torch.Tensor, *, deg: int, ncv: int, orth: int, rtol: float, reorth_passes: int, return_basis: bool,
	coeffs, basis_dtype, selective: bool,
) -> LanczosOutput:
	"""The sweep of :func:`_lanczos_core` out of place, for reverse mode (``jax.grad`` through the
	JAX package's ``lax.scan``, ``primate_tpu/lanczos.py:296-408``): each step applies
	``op.matmat_t`` (the kernels' autograd Functions on DIA, BSR and CSR operators), never a step
	kernel, and writes nothing in place; the basis window is a list of blocks. The divisor of a
	broken-down probe is guarded before the division, and ``β = ‖v‖`` has a zero gradient at
	``v = 0``, so no NaN comes back through an untaken branch. The CGS window is broadcast products
	and sums over valid slots only, no matmul. Real operators only, as in JAX."""
	nv, n = V0t.shape
	dtype, device = V0t.dtype, V0t.device
	if dtype.is_complex:
		raise NotImplementedError(
			"reverse mode through the Lanczos recurrence is real only, as JAX's gradients are: differentiate a "
			"Hermitian operator through its real embedding [[Re, -Im], [Im, Re]]"
		)
	acc = torch.promote_types(dtype, torch.float32)
	b_dtype = basis_dtype or dtype
	keep_window = return_basis or orth > 0 or selective
	residual_tol = float(np.sqrt(n) * rtol)

	def norm(x: torch.Tensor) -> torch.Tensor:
		sq = torch.sum(x * x, dim=1)
		pos = sq > 0
		return torch.where(pos, torch.sqrt(torch.where(pos, sq, 1.0)), 0.0)

	norm0 = norm(V0t.to(acc))
	q0 = (V0t / torch.where(norm0 > 0, norm0, 1)[:, None].to(dtype)).to(dtype)
	window = [q0.to(b_dtype)] + [torch.zeros((nv, n), dtype=b_dtype, device=device)] * (ncv - 1) if keep_window else None
	y = None
	if coeffs is not None:
		coeffs = torch.as_tensor(coeffs, device=device)
		coeffs = coeffs.to(acc)
		y = torch.zeros(coeffs.shape[1:] + (n,), dtype=acc, device=device)

	def cgs(v: torch.Tensor, slots: list) -> torch.Tensor:
		for _ in range(max(1, reorth_passes)):
			proj = [torch.sum(window[s] * v, dim=1) for s in slots]
			for s, p in zip(slots, proj):
				v = v - window[s] * p[:, None].to(acc)
		return v

	omega = _Omega(nv, ncv, n, acc, device) if selective else None
	alphas, betas = [], []
	q_prev, q_cur = torch.zeros((nv, n), dtype=dtype, device=device), q0
	beta_j = torch.zeros(nv, dtype=acc, device=device)
	done = torch.zeros(nv, dtype=torch.bool, device=device)
	for j in range(deg):
		qc = q_cur.to(acc)
		if y is not None:
			y = y + coeffs[j][..., None] * qc
		v = op.matmat_t(q_cur).to(acc) - beta_j[:, None] * q_prev.to(acc)
		alpha_j = torch.sum(v * qc, dim=1)
		v = v - alpha_j[:, None] * qc
		if selective:
			trigger = omega.breach(j, alpha_j.detach(), beta_j.detach(), row_sq_norm(v.detach()), done)
			if trigger:
				v = cgs(v, [s for s in range(ncv) if (j - s) % ncv <= j])
			omega.advance(j, trigger)
		elif orth > 0:
			v = cgs(v, [s for s in range(ncv) if (j - s) % ncv < orth and (j - s) % ncv <= j])
		beta_next = norm(v)
		newly_done = beta_next.detach() < residual_tol
		alphas.append(torch.where(done, 0.0, alpha_j))
		betas.append(torch.where(done, 0.0, beta_next))
		live = beta_next.detach() > residual_tol
		q_next = torch.where(live[:, None], v / torch.where(live, beta_next, 1.0)[:, None], 0.0).to(dtype)
		if keep_window:
			slot = (j + 1) % ncv
			if not return_basis:
				window[slot] = q_next.to(b_dtype)
			elif j + 1 < deg:
				window[slot] = torch.where((~(done | newly_done))[:, None], q_next.to(b_dtype), window[slot])
		q_prev, q_cur, beta_j, done = q_cur, q_next, beta_next, done | newly_done
	return LanczosOutput(
		alphas=torch.stack(alphas),
		betas=torch.stack(betas),
		Q=torch.stack(window).permute(0, 2, 1) if keep_window else None,
		y=y.transpose(-1, -2) if y is not None else None,
		reorth_steps=torch.tensor(omega.triggers, dtype=torch.bool) if selective else None,
	)


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
