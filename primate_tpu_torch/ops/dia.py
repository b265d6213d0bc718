"""DIA stencil kernels: wrappers, plain PyTorch versions, launch counts.

Three hand-written CUDA kernels (``csrc/dia_stencil.cu``) replace the Pallas TPU
kernels of ``primate_tpu/ops/dia_pallas.py``:

* :func:`dia_stencil_t` replaces ``dia_matmat_t_pallas`` (``_dia_t_kernel``):
  ``out[b, r] = Σ_d bands[d, r] · X[b, r + off_d]``, probe-major. It is
  ``DIAOperator.matmat_t``, the quadratic forms of a plain DIA operator, and the
  node-major apply of a block whose transpose is contiguous. Each thread takes
  one 16-byte vector of rows through every probe, so the bands are read once;
  it loads and stores 16-byte vectors where ``n`` and the pointers allow,
  elements otherwise (counted in ``SCALAR_LAUNCHES``).
* :func:`dia_stencil` replaces ``dia_matmat_pallas`` (``_dia_kernel``):
  ``out[r, :] = Σ_d bands[d, r] · V[r + off_d, :]``, node-major, the apply of a
  contiguous ``(n, k)`` block (a QR factor, a GEMM product). A thread takes one
  16-byte vector of columns through two rows and issues the loads of four diagonals
  together; the nearby diagonals find their rows in L1, the far ones in L2. 16-byte
  vectors along k where ``k`` and the pointers allow, elements otherwise (counted in
  ``SCALAR_LAUNCHES``).
* :func:`lanczos_dia_step` (pass A) and ``lanczos_dia_residual`` (pass B) replace
  ``dia_matmat_t_phys`` (``_dia_t_phys_kernel``), the stencil of the Lanczos sweep.
  On the TPU a ``pallas_call`` could not join XLA's fusion of the stencil with the
  rest of the step (``primate_tpu/lanczos.py:101-104``); here
  :func:`lanczos_dia_sweep_step` runs the whole step without re-orthogonalisation
  as the two passes: pass A ``w = A·q − β·q_prev`` and α, pass B ``v = w − α·q``,
  β' = ‖v‖, the done flags and the next divisors, each pass finishing its sums on
  the card in a fixed order (no atomics, so α and β are deterministic). The sweep
  carries v unnormalised with its guarded divisor (:class:`LanczosState`), so no
  pass normalises. :func:`lanczos_dia_step` alone is pass A for a sweep that
  re-orthogonalises, its α partials summed by ``torch.sum``.

  Both passes take the sweep's carry in its layout (:class:`CarrySpec`, the port's
  ``phys_spec``): the flat ``(nv, n)`` block, or the halo-padded ``(nv, ld)`` one with the rows
  at ``[lo, lo + n)`` that ``lanczos_block_op(phys=True)`` and the row-sharded sweep carry
  (``lo`` and ``ld`` whole 128-byte lines, so both passes take their vector paths on aligned lines). They read
  the columns outside the rows as data (zeros, or a neighbour rank's rows after a halo exchange)
  and write zeros there. On a row-sharded carry (``reduce`` given) each pass writes only the
  rank's sums and the caller all-reduces them between the passes; the step's finish (α, β, the
  divisors and the done flags, from the reduced sums, so every rank advances alike) is left
  pending in the state and runs in pass A of the next step: two launches a step, as unsharded.
  :func:`lanczos_dia_finish` runs a pending finish by itself (``lanczos_dia_advance``, one thread a
  probe) where the sweep reads the state between steps and at its end.

bfloat16 (JAX's third operator dtype): the two stencils and pass A read bf16 bands and blocks
and sum in float32; the stencils round once to bf16 where they write, pass A writes ``w`` and α
in float32. Pass A takes one switch, ``rounded``: round the stencil sum to the carry's dtype
before ``− β·q_prev`` (the flat and the row-sharded sweeps, as JAX's ``matmat_t`` returns the
operator's dtype) or not (``lanczos_block_op(phys=True)``, as ``dia_matmat_t_phys`` returns
float32). It changes nothing in float32 and float64. The bf16 sweep rounds q every step, so the
unnormalised carry of pass B cannot serve it (pass B and the advance's state arithmetic are
float32/float64): :func:`lanczos_dia_round_step` runs pass A and :func:`lanczos_dia_round`, a pair
of kernels over w and q (B1 ``‖w − α·q‖²`` and the step's scalars, B2 ``q_next = bf16((w − α·q)/β')``),
three launches a step with no PyTorch op between them (on a row-sharded carry the two sums are
all-reduced and B2 finishes the step's scalars from them).

Complex (Hermitian) blocks: the two stencils and both step passes have complex64/complex128
instantiations (a 16-byte vector holds 2 or 1 elements). The step's ``w`` and ``v`` are complex, its
state, α, β and every sum real (``α = Re Σ conj(q)·w``, JAX's ``primate_tpu/lanczos.py:309-316``), and
its elementwise ops round as the plain version's PyTorch ops do on the card. Complex pass A holds
its band values in registers as ``dia_stencil_t`` does; the real and bfloat16 ones stage the carry.

All are bound by HBM bytes (a few flops per loaded element); the kernels make
one pass over the probe block and bounds-check the ragged edges, so neither the
TPU's 128-lane halo and ``LANE_TILE`` rounding nor its ``nv % 8`` and ``k % 128``
rules carry over.

Each wrapper runs its plain version (``*_ref``) only for tensors on the CPU. For
a CUDA tensor it launches the kernel or raises; it counts each launch in
:data:`LAUNCHES`. The two stencils write out a lazy conjugate or negation of their
inputs first (``x.conj()`` shares ``x``'s memory), so the kernel reads the values the
plain version reads.
"""

from dataclasses import dataclass, field
from typing import List, NamedTuple, Optional, Tuple

import torch

from ._common import LAUNCHES, SUFFIX, acc_dtype, check_cuda, count_launch, raise_on, reset_launches, resolved, stream, vector_ok

__all__ = [
	"LAUNCHES",
	"reset_launches",
	"dia_stencil",
	"dia_stencil_ref",
	"dia_stencil_t",
	"dia_stencil_t_ref",
	"lanczos_dia_step",
	"lanczos_dia_step_ref",
	"LanczosState",
	"Finish",
	"row_dot",
	"row_sq_norm",
	"lanczos_state",
	"lanczos_dia_sweep_step",
	"lanczos_sweep_step_ref",
	"lanczos_sweep_pass_a_ref",
	"lanczos_sweep_pass_b_ref",
	"lanczos_dia_advance_ref",
	"lanczos_dia_finish",
	"lanczos_sharded_step_ref",
	"lanczos_round_ref",
	"lanczos_dia_round",
	"lanczos_dia_round_ref",
	"lanczos_round_pair_ref",
	"lanczos_dia_round_step",
	"CarrySpec",
	"carry_spec",
]


def dia_stencil_ref(bands: torch.Tensor, offsets: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
	"""Plain version of :func:`dia_stencil`: ``out[r, :] = Σ_d bands[d, r]·V[r + off_d, :]``,
	accumulated in ``promote_types(dtype, float32)`` and returned in ``V.dtype``."""
	n, k = V.shape
	acc = acc_dtype(V.dtype)
	out = torch.zeros((n, k), dtype=acc, device=V.device)
	for d, off in enumerate(offsets.tolist()):
		lo, hi = max(0, -off), min(n, n - off)
		if lo < hi:
			out[lo:hi] += bands[d, lo:hi, None].to(acc) * V[lo + off : hi + off].to(acc)
	return out.to(V.dtype)


def _stencil_t_acc(bands: torch.Tensor, offsets: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
	"""``Σ_d bands[d, r]·x[b, r + off_d]`` in ``promote_types(dtype, float32)``, unrounded."""
	nv, n = x.shape
	acc = acc_dtype(x.dtype)
	out = torch.zeros((nv, n), dtype=acc, device=x.device)
	for d, off in enumerate(offsets.tolist()):
		lo, hi = max(0, -off), min(n, n - off)
		if lo < hi:
			out[:, lo:hi] += bands[d, lo:hi].to(acc) * x[:, lo + off : hi + off].to(acc)
	return out


def dia_stencil_t_ref(bands: torch.Tensor, offsets: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
	"""Plain version of :func:`dia_stencil_t`: ``out[b, r] = Σ_d bands[d, r]·x[b, r + off_d]``,
	accumulated in ``promote_types(dtype, float32)`` and returned in ``x.dtype``."""
	return _stencil_t_acc(bands, offsets, x).to(x.dtype)


def row_dot(X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
	"""``Re Σ_r conj(X[b, r])·Y[b, r]`` per row (``Σ X·Y`` for real blocks): the real inner
	products of a Hermitian Lanczos step (``primate_tpu/lanczos.py:312-315``)."""
	return torch.real(torch.sum(X.conj() * Y, dim=1)) if X.is_complex() else torch.sum(Y * X, dim=1)


def row_sq_norm(X: torch.Tensor) -> torch.Tensor:
	"""``Σ_r |X[b, r]|²`` per row, real."""
	return torch.sum(torch.view_as_real(X).square(), dim=(1, 2)) if X.is_complex() else torch.sum(X * X, dim=1)


class CarrySpec(NamedTuple):
	"""The layout of a Lanczos carry, the port's form of JAX's ``phys_spec``: a probe-major block
	``(nv, ld)`` whose own rows are the columns ``[lo, lo + n)``; the bands that the step kernels
	read on it are ``(n_d, ld)`` in the same columns, zero outside the own rows. The columns outside
	the own rows are zero, or hold a neighbour rank's rows after a halo exchange. The flat carry
	``(nv, n)`` is ``CarrySpec(n, 0, n)``."""

	ld: int
	lo: int
	n: int

	def rows(self, X: torch.Tensor) -> torch.Tensor:
		"""The own rows of a carry (a view)."""
		return X if self.ld == self.n else X.narrow(-1, self.lo, self.n)

	def pad(self, X: torch.Tensor) -> torch.Tensor:
		"""A ``(..., n)`` block in a new carry ``(..., ld)``, zero outside the own rows."""
		if self.ld == self.n:
			return X
		out = X.new_zeros(X.shape[:-1] + (self.ld,))
		self.rows(out).copy_(X)
		return out

	def zero_margins(self, X: torch.Tensor) -> torch.Tensor:
		"""Zero ``X``'s columns outside the own rows, in place; returns ``X``."""
		if self.ld != self.n:
			X[..., : self.lo] = 0
			X[..., self.lo + self.n :] = 0
		return X


def carry_spec(n: int, max_offset: int, elem_size: int) -> CarrySpec:
	"""The padded carry of ``n`` rows for offsets up to ``max_offset``: ``lo`` the largest offset
	rounded up to a whole 128-byte line, ``ld`` room for ``max_offset`` columns past the rows,
	rounded up the same way. Whole 16-byte vectors put the step kernels and ``dia_stencil_t`` on
	their vector paths; whole lines keep each warp's 512-byte accesses on four lines, not five (with
	``lo`` one vector, pass B took 3.01 ms at 64 × 10M float32 against 2.76 ms line-aligned and 2.64
	ms on the flat carry; H100 80GB HBM3, 700 W)."""
	line = max(1, 128 // elem_size)
	lo = -(-max_offset // line) * line
	return CarrySpec(-(-(lo + n + max_offset) // line) * line, lo, n)


# Diagonals whose band values a thread of the probe-major stencil holds (``kTChunk``).
T_CHUNK = 8


def _flat(X: torch.Tensor) -> CarrySpec:
	return CarrySpec(X.shape[-1], 0, X.shape[-1])


def _same(x):
	return x


def lanczos_dia_step_ref(
	bands: torch.Tensor, offsets: torch.Tensor, q_cur: torch.Tensor, q_prev: torch.Tensor, beta: torch.Tensor,
	spec: Optional[CarrySpec] = None, reduce=_same, rounded: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
	"""Plain version of :func:`lanczos_dia_step`: ``v = A·q_cur − β·q_prev`` (zero outside the
	own rows of ``spec``'s carry) in the accumulation dtype and ``α = Re Σ_r conj(q_cur)·v`` over the
	own rows (``Σ v·q_cur`` for real blocks; real), finished by ``reduce``
	(``primate_tpu/lanczos.py:309-315``). ``rounded``:
	``A·q_cur`` is rounded to ``q_cur``'s dtype first, as JAX's flat step rounds ``matmat_t``'s
	output (``:309``), or kept in the accumulation dtype, as ``dia_matmat_t_phys`` returns it
	(a no-op in float32 and float64)."""
	spec = spec or _flat(q_cur)
	acc = acc_dtype(q_cur.dtype)
	Aq = _stencil_t_acc(bands, offsets, q_cur)
	if rounded:
		Aq = Aq.to(q_cur.dtype).to(acc)
	v = spec.zero_margins(Aq - beta[:, None].to(acc) * q_prev.to(acc))
	alpha = reduce(row_dot(spec.rows(q_cur).to(acc), spec.rows(v)))
	return v, alpha


# Rows of a sweep's per-probe state, as the step kernels read and update them
# (``csrc/dia_stencil.cu``): the guarded divisors of the carried residuals
# (q = v / div), the coupling β, the done flags (0 or 1) and the step's α.
DIV_CUR, DIV_PREV, BETA, DONE, ALPHA = range(5)


class Finish(NamedTuple):
	"""The finish of a row-sharded step, pending: its reduced sums ``(2, nv)`` (α, and Σ|v|² over every
	rank's rows), the sweep's output rows it writes (``alpha_out``, ``beta_out``) and the residual
	tolerance. The sums tensor is the step's own, so it stays alive until the finish has read it."""

	sums: torch.Tensor
	alpha_out: torch.Tensor
	beta_out: torch.Tensor
	tol: float


@dataclass
class LanczosState:
	"""What a sweep carries from step to step besides its two residual blocks:
	``scal (5, nv)`` in the accumulation dtype (rows :data:`DIV_CUR` … :data:`ALPHA`),
	updated in place by each step, ``ticket (1,)`` int32, a counter the kernels
	use to find the last block of a pass (0 between launches), and ``pending``, the finish of a
	row-sharded step not yet run (:class:`Finish`; at most one, run by the next step's pass A or by
	:func:`lanczos_dia_finish`)."""

	scal: torch.Tensor
	ticket: torch.Tensor
	pending: List[Finish] = field(default_factory=list)


def lanczos_state(nv: int, dtype: torch.dtype, device) -> LanczosState:
	"""The state before the first step: q = v (divisors 1), β = 0, nothing done, nothing pending."""
	scal = torch.zeros((5, nv), dtype=dtype, device=device)
	scal[DIV_CUR] = 1
	scal[DIV_PREV] = 1
	return LanczosState(scal, torch.zeros(1, dtype=torch.int32, device=device))


def _finish_alpha(s: torch.Tensor, alpha: torch.Tensor, alpha_out: torch.Tensor) -> None:
	"""What the end of pass A writes: ``s[ALPHA]`` and ``alpha_out`` (zero where a probe is done)."""
	alpha_out.copy_(torch.where(s[DONE] != 0, 0.0, alpha))
	s[ALPHA] = alpha


def _finish_beta(s: torch.Tensor, beta: torch.Tensor, beta_out: torch.Tensor, residual_tol: float) -> None:
	"""What the end of pass B writes: ``beta_out`` (zero where a probe was done) and the advanced state."""
	done = s[DONE] != 0
	beta_out.copy_(torch.where(done, 0.0, beta))
	s[DIV_PREV] = s[DIV_CUR]
	s[DIV_CUR] = torch.where(beta > residual_tol, beta, torch.inf)
	s[BETA] = beta
	s[DONE] = (done | (beta < residual_tol)).to(s.dtype)


def _pass_a_plain(apply_t, v_cur, v_prev, s, reduce, spec: CarrySpec) -> Tuple[torch.Tensor, torch.Tensor]:
	"""Pass A's arithmetic from the state ``s`` as it stands, writing nothing: ``w`` and the reduced α."""
	q = v_cur / s[DIV_CUR, :, None]
	w = spec.zero_margins(apply_t(q).to(v_cur.dtype) - s[BETA, :, None] * (v_prev / s[DIV_PREV, :, None]))
	return w, reduce(row_dot(spec.rows(q), spec.rows(w)))


def _pass_b_plain(v_cur, w, alpha, s, reduce, spec: CarrySpec) -> Tuple[torch.Tensor, torch.Tensor]:
	"""Pass B's arithmetic, writing nothing but ``v`` in place of ``w``: ``v`` and the reduced Σ|v|²."""
	v = spec.zero_margins(w.sub_(alpha[:, None] * (v_cur / s[DIV_CUR, :, None])))
	return v, reduce(row_sq_norm(spec.rows(v)))


def lanczos_sweep_pass_a_ref(
	apply_t, v_cur: torch.Tensor, v_prev: torch.Tensor, state: LanczosState, alpha_out: torch.Tensor,
	reduce=_same, spec: Optional[CarrySpec] = None,
) -> torch.Tensor:
	"""Plain version of pass A: with ``q = v_cur / div_cur`` and ``q_prev = v_prev / div_prev``,
	returns ``w = A q − β q_prev``, zero outside the own rows of ``spec``'s carry (the flat carry
	when None); writes ``α = Re Σ conj(q)·w`` over the own rows (``Σ w q`` for real blocks) to
	``state.scal[ALPHA]`` and to ``alpha_out`` (zero where a probe is done). The state is real for
	complex (Hermitian) blocks too. On a row-sharded carry ``reduce`` finishes the sum over the
	other ranks' rows (the identity otherwise)."""
	w, alpha = _pass_a_plain(apply_t, v_cur, v_prev, state.scal, reduce, spec or _flat(v_cur))
	_finish_alpha(state.scal, alpha, alpha_out)
	return w


def lanczos_sweep_pass_b_ref(
	v_cur: torch.Tensor, w: torch.Tensor, state: LanczosState, beta_out: torch.Tensor, residual_tol: float,
	reduce=_same, spec: Optional[CarrySpec] = None,
) -> torch.Tensor:
	"""Plain version of pass B: ``v = w − α q`` in place of ``w`` (zero outside the own rows),
	``β' = ‖v‖`` (``√Σ|v|²`` over the own rows); writes ``beta_out`` (zero where a probe was done)
	and advances ``state``: ``div_prev = div_cur``, ``div_cur = β'`` if ``β' > residual_tol`` else
	``inf``, ``β = β'``, ``done |= β' < residual_tol``. ``reduce`` and ``spec`` as in pass A."""
	s = state.scal
	v, sq = _pass_b_plain(v_cur, w, s[ALPHA], s, reduce, spec or _flat(v_cur))
	_finish_beta(s, torch.sqrt(sq), beta_out, residual_tol)
	return v


def lanczos_dia_advance_ref(
	sums: torch.Tensor, state: LanczosState, alpha_out: torch.Tensor, beta_out: torch.Tensor, residual_tol: float
) -> None:
	"""Plain version of ``lanczos_dia_advance``, the finish of a row-sharded step: from the reduced
	sums ``(2, nv)`` (α, and Σ|v|² over every rank's rows) it writes what passes A and B write at the
	end of an unsharded step: ``state[ALPHA] = α``, ``alpha_out``/``beta_out`` (zero where a probe was
	done), ``div_prev = div_cur``, ``div_cur = β'`` if ``β' > residual_tol`` else ``inf``, ``β = β'``,
	``done |= β' < residual_tol`` with ``β' = √Σ|v|²``."""
	_finish_alpha(state.scal, sums[0], alpha_out)
	_finish_beta(state.scal, torch.sqrt(sums[1]), beta_out, residual_tol)


def _finish_plain(state: LanczosState) -> None:
	"""The pending finish of ``state``, if any, by :func:`lanczos_dia_advance_ref`."""
	if state.pending:
		f = state.pending.pop()
		lanczos_dia_advance_ref(f.sums, state, f.alpha_out, f.beta_out, f.tol)


def lanczos_dia_finish(state: LanczosState) -> None:
	"""Run the pending finish of a row-sharded sweep's last step (see :class:`Finish`), if there is one:
	on the card the ``lanczos_dia_advance`` kernel, on the CPU its plain version. The sweep calls it
	(through ``ShardedDIAOperator.lanczos_sweep_flush``) before it reads the state between steps and
	at its end; with nothing pending it does nothing."""
	if not state.pending:
		return
	if state.scal.device.type == "cpu":
		_finish_plain(state)
		return
	from ._build import load_library

	f = state.pending.pop()
	_launch_advance(load_library(), f.sums, state, f.alpha_out, f.beta_out, f.tol)


def lanczos_sharded_step_ref(
	apply_t, v_cur: torch.Tensor, v_prev: torch.Tensor, state: LanczosState, alpha_out: torch.Tensor,
	beta_out: torch.Tensor, residual_tol: float, reduce, spec: Optional[CarrySpec] = None,
) -> torch.Tensor:
	"""Plain version of :func:`lanczos_dia_sweep_step` on a row-sharded carry, the finish deferred as the
	kernels defer it: the pending finish of the step before runs first (where pass A runs it on the card),
	then both passes' arithmetic from the state as it stands, each sum finished by ``reduce``, and this
	step's finish is left pending in ``state`` (its outputs and the state are written by the next step or
	by :func:`lanczos_dia_finish`). Bit for bit :func:`lanczos_sweep_step_ref` with ``reduce`` once the
	finish has run: the same operations on the same values, only later."""
	spec = spec or _flat(v_cur)
	_finish_plain(state)
	s = state.scal
	w, alpha = _pass_a_plain(apply_t, v_cur, v_prev, s, reduce, spec)
	v, sq = _pass_b_plain(v_cur, w, alpha, s, reduce, spec)
	state.pending.append(Finish(torch.stack([alpha, sq]), alpha_out, beta_out, float(residual_tol)))
	return v


def lanczos_sweep_step_ref(
	apply_t, v_cur: torch.Tensor, v_prev: torch.Tensor, state: LanczosState, alpha_out: torch.Tensor,
	beta_out: torch.Tensor, residual_tol: float, reduce=_same, spec: Optional[CarrySpec] = None,
) -> torch.Tensor:
	"""Plain version of :func:`lanczos_dia_sweep_step`, for any probe-major apply
	``apply_t`` (``primate_tpu/lanczos.py:304-316,378-388`` with ``orth = 0``): pass A
	then pass B. The next step's ``q = v / div_cur`` is the reference's guarded ``v / β'``.
	``reduce`` and ``spec`` route the two sums of a row-sharded or padded carry (see pass A)."""
	w = lanczos_sweep_pass_a_ref(apply_t, v_cur, v_prev, state, alpha_out, reduce, spec)
	return lanczos_sweep_pass_b_ref(v_cur, w, state, beta_out, residual_tol, reduce, spec)


def lanczos_round_ref(
	w: torch.Tensor, alpha: torch.Tensor, q_cur: torch.Tensor, state: LanczosState, alpha_out: torch.Tensor,
	beta_out: torch.Tensor, residual_tol: float, rows=_same, reduce=_same,
) -> torch.Tensor:
	"""The rest of a Lanczos step whose q is stored narrower than it is summed (bfloat16), after
	``w = A·q_cur − β·q_prev`` and α (``primate_tpu/lanczos.py:316,378-388``), as PyTorch ops:
	``v = w − α·q_cur`` in place of ``w``, ``β' = √Σ|v|²`` over ``rows`` finished by ``reduce``;
	writes ``alpha_out``/``beta_out`` (zero where a probe was done) and advances ``state`` as pass B
	does (``β = β'``, ``div_cur = β'`` if ``β' > residual_tol`` else ``inf``, ``done |= β' <
	residual_tol``, and ``state[ALPHA] = α``); returns ``q_next = v / div_cur`` rounded to
	``q_cur``'s dtype (0 for a probe that broke down)."""
	s = state.scal
	w.addcmul_(alpha[:, None], q_cur.to(w.dtype), value=-1)
	beta = torch.sqrt(reduce(row_sq_norm(rows(w))))
	_finish_alpha(s, alpha, alpha_out)
	_finish_beta(s, beta, beta_out, residual_tol)
	return w.div_(s[DIV_CUR, :, None]).to(q_cur.dtype)


def lanczos_dia_round_ref(
	w: torch.Tensor, q_cur: torch.Tensor, state: LanczosState, alpha_out: torch.Tensor, beta_out: torch.Tensor,
	residual_tol: float, spec: Optional[CarrySpec] = None, reduce=_same, sums: Optional[torch.Tensor] = None,
) -> torch.Tensor:
	"""Plain version of :func:`lanczos_dia_round`: :func:`lanczos_round_ref` over the own rows of
	``spec``'s carry, α from ``state[ALPHA]`` (pass A's) or, on a row-sharded carry, from the reduced
	``sums[0]``; ``q_next`` with zero margins."""
	spec = spec or _flat(q_cur)
	alpha = state.scal[ALPHA] if sums is None else sums[0]
	return spec.zero_margins(lanczos_round_ref(w, alpha, q_cur, state, alpha_out, beta_out, residual_tol, spec.rows, reduce))


def lanczos_round_pair_ref(
	w: torch.Tensor, q_cur: torch.Tensor, state: LanczosState, alpha_out: torch.Tensor, beta_out: torch.Tensor,
	residual_tol: float, spec: CarrySpec, reduce, sums: torch.Tensor,
) -> torch.Tensor:
	"""Plain version of :func:`lanczos_dia_round` on a row-sharded carry, split as its kernels split it: B1
	the rank's ``Σ(w − α·q)²`` over the own rows (α the reduced ``sums[0]``) into ``sums[1]``, ``reduce``
	finishes it, then B2 the step's finish from the reduced sums (what :func:`lanczos_dia_advance_ref`
	writes) and ``q_next``. ``w`` is left alone. Bit for bit :func:`lanczos_dia_round_ref` with ``sums``."""
	v = w.addcmul(sums[0][:, None], q_cur.to(w.dtype), value=-1)
	sums[1] = reduce(row_sq_norm(spec.rows(v)))
	lanczos_dia_advance_ref(sums, state, alpha_out, beta_out, residual_tol)
	return spec.zero_margins(v.div_(state.scal[DIV_CUR, :, None]).to(q_cur.dtype))


def _check_shapes(name: str, bands: torch.Tensor, offsets: torch.Tensor, x: torch.Tensor) -> None:
	if x.ndim != 2 or bands.ndim != 2 or offsets.ndim != 1:
		raise ValueError(f"{name}: expected x (nv, n), bands (n_d, n), offsets (n_d,)")
	if bands.shape != (offsets.shape[0], x.shape[1]):
		raise ValueError(f"{name}: bands {tuple(bands.shape)} do not match offsets {tuple(offsets.shape)} and n={x.shape[1]}")


def _check_spec(name: str, spec: CarrySpec, x: torch.Tensor) -> CarrySpec:
	spec = CarrySpec(*(int(v) for v in spec)) if spec is not None else _flat(x)
	if spec.ld != x.shape[1] or spec.lo < 0 or spec.n < 1 or spec.lo + spec.n > spec.ld:
		raise ValueError(f"{name}: carry layout {tuple(spec)} does not fit a carry of width {x.shape[1]}")
	return spec


def _check_real(name: str, **tensors) -> None:
	"""A step's state, β and outputs are real, for complex (Hermitian) carries too."""
	for key, t in tensors.items():
		if t.is_complex():
			raise TypeError(f"{name}: {key} must be real (the real accumulation dtype); got {t.dtype}")


def dia_stencil_t(bands: torch.Tensor, offsets: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
	"""Probe-major DIA stencil ``out[b, r] = Σ_d bands[d, r]·x[b, r + off_d]``.

	``bands (n_d, n)`` row-aligned, ``offsets (n_d,)`` int64, ``x (nv, n)``; any offsets.
	"""
	_check_shapes("dia_stencil_t", bands, offsets, x)
	if x.device.type == "cpu":
		return dia_stencil_t_ref(bands, offsets, x)
	bands, x = resolved(bands), resolved(x)
	check_cuda(
		"dia_stencil_t", x.dtype, x.device, ("offsets",), complex_ok=True, bf16_ok=True, bands=bands, offsets=offsets, x=x
	)
	from ._build import load_library

	lib = load_library()
	nv, n = x.shape
	out = torch.empty_like(x)
	# bfloat16 with more diagonals than the kernel's chunk of band slots: the float32 sums of the
	# chunks before the last go through this scratch, so the output is rounded once.
	mid = torch.empty((nv, n), dtype=torch.float32, device=x.device) if x.dtype == torch.bfloat16 and bands.shape[0] > T_CHUNK else None
	vec = vector_ok(n, x.element_size(), x, out, bands, *([mid] if mid is not None else []))
	fn = getattr(lib, f"dia_stencil_t_{SUFFIX[x.dtype]}")
	err = fn(
		bands.data_ptr(), offsets.data_ptr(), bands.shape[0], x.data_ptr(), out.data_ptr(), mid.data_ptr() if mid is not None else None,
		nv, n, int(vec), stream(x.device),
	)
	raise_on(lib, err, "dia_stencil_t")
	count_launch("dia_stencil_t", x.dtype, vec)
	return out


def _launch_pass_a(lib, bands, offsets, v_cur, v_prev, scal, ticket, alpha_out, spec=None, sums=None, rounded=True, pending=None):
	"""Pass A on the card: returns w (in the accumulation dtype: float32 for a bfloat16 carry,
	complex for a complex one), the (nv, grid) α partials (real), the grid and the vector flag. With
	``sums`` (nv,) the last block writes the rank's α sums there and leaves the state alone, but for
	``pending`` (a :class:`Finish`, float32/float64 only): the step before's finish, which every block
	applies to the divisors and β it reads, and the last block writes to the state and the outputs."""
	spec = spec or _flat(v_cur)
	nv = v_cur.shape[0]
	gx = lib.lanczos_step_blocks(nv, spec.n, v_cur.element_size(), int(v_cur.is_complex()))
	if gx < 1:
		raise RuntimeError("lanczos_dia_step: could not query the CUDA device for the grid size")
	acc = acc_dtype(v_cur.dtype)
	w = torch.empty(v_cur.shape, dtype=acc, device=v_cur.device)
	partial = torch.empty((nv, gx), dtype=acc.to_real(), device=v_cur.device)
	vec = vector_ok(spec.ld, v_cur.element_size(), bands, v_cur, v_prev, w, lead=spec.lo)
	ptr = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
	if pending is None:
		err = getattr(lib, f"lanczos_dia_step_{SUFFIX[v_cur.dtype]}")(
			bands.data_ptr(), offsets.data_ptr(), bands.shape[0], v_cur.data_ptr(), v_prev.data_ptr(), scal.data_ptr(),
			w.data_ptr(), partial.data_ptr(), ptr(ticket), ptr(alpha_out), ptr(sums), nv, spec.ld, spec.lo, spec.n, gx,
			int(rounded), int(vec), stream(v_cur.device),
		)
	else:
		if v_cur.dtype not in (torch.float32, torch.float64) or pending.sums.dtype != scal.dtype:
			raise TypeError(f"lanczos_dia_step: a pending finish takes a float32/float64 carry and its state's dtype; got {v_cur.dtype}")
		err = getattr(lib, f"lanczos_dia_step_finish_{SUFFIX[v_cur.dtype]}")(
			bands.data_ptr(), offsets.data_ptr(), bands.shape[0], v_cur.data_ptr(), v_prev.data_ptr(), scal.data_ptr(),
			w.data_ptr(), partial.data_ptr(), ptr(ticket), ptr(sums), pending.sums.data_ptr(), pending.alpha_out.data_ptr(),
			pending.beta_out.data_ptr(), pending.tol, nv, spec.ld, spec.lo, spec.n, gx, int(vec), stream(v_cur.device),
		)
	raise_on(lib, err, "lanczos_dia_step")
	count_launch("lanczos_dia_step", v_cur.dtype, vec)
	return w, partial, gx, vec


def _launch_pass_b(lib, v_cur, w, state, partial, beta_out, residual_tol, gx, vec, spec=None, sums=None) -> None:
	"""Pass B on the card, on pass A's w (in place) and partials buffer. With ``sums`` (2, nv) it
	reads α from ``sums[0]`` (reduced) and writes the rank's ``|v|²`` sums to ``sums[1]``."""
	spec = spec or _flat(v_cur)
	nv = v_cur.shape[0]
	fn = getattr(lib, f"lanczos_dia_residual_{SUFFIX[v_cur.dtype]}")
	scal = state.scal
	alpha_src = sums[0] if sums is not None else scal[ALPHA]
	err = fn(
		v_cur.data_ptr(), w.data_ptr(), scal.data_ptr(), alpha_src.data_ptr(), partial.data_ptr(), state.ticket.data_ptr(),
		beta_out.data_ptr(), sums[1].data_ptr() if sums is not None else None, nv, spec.ld, spec.lo, spec.n,
		float(residual_tol), gx, int(vec), stream(v_cur.device),
	)
	raise_on(lib, err, "lanczos_dia_residual")
	count_launch("lanczos_dia_residual", v_cur.dtype, vec)


def _launch_advance(lib, sums, state, alpha_out, beta_out, residual_tol) -> None:
	"""The step's finish from the reduced sums (2, nv): α, β, the divisors and the done flags."""
	fn = lib.lanczos_dia_advance_f32 if sums.dtype == torch.float32 else lib.lanczos_dia_advance_f64
	err = fn(
		sums.data_ptr(), state.scal.data_ptr(), alpha_out.data_ptr(), beta_out.data_ptr(), sums.shape[1],
		float(residual_tol), stream(sums.device),
	)
	raise_on(lib, err, "lanczos_dia_advance")
	LAUNCHES["lanczos_dia_advance"] += 1


def _launch_round(lib, w, q_cur, state, alpha_out, beta_out, residual_tol, spec, reduce=None, sums=None):
	"""The round pair on the card, on a grid of its own (``lanczos_round_blocks``): B1 (α from ``state[ALPHA]``,
	or from the reduced ``sums[0]``: then B1 writes the rank's Σv² to ``sums[1]`` and ``reduce`` finishes it),
	then B2 (with ``sums``, it finishes the step's scalars from them). Returns q_next."""
	nv = q_cur.shape[0]
	gx = lib.lanczos_round_blocks(nv, spec.n)
	if gx < 1:
		raise RuntimeError("lanczos_dia_round: could not query the CUDA device for the grid size")
	partial = torch.empty((nv, gx), dtype=torch.float32, device=q_cur.device)
	q_next = torch.empty_like(q_cur)
	vec = vector_ok(spec.ld, q_cur.element_size(), w, q_cur, q_next, lead=spec.lo)
	scal = state.scal
	alpha_src = scal[ALPHA] if sums is None else sums[0]
	err = lib.lanczos_dia_round_norm_bf16(
		w.data_ptr(), q_cur.data_ptr(), scal.data_ptr(), alpha_src.data_ptr(), partial.data_ptr(), state.ticket.data_ptr(),
		alpha_out.data_ptr(), beta_out.data_ptr(), sums[1].data_ptr() if sums is not None else None, nv, spec.ld, spec.lo,
		spec.n, float(residual_tol), gx, int(vec), stream(q_cur.device),
	)
	raise_on(lib, err, "lanczos_dia_round")
	fin = (None, None, None)
	if sums is not None:
		reduce(sums[1])
		fin = (sums.data_ptr(), alpha_out.data_ptr(), beta_out.data_ptr())
	err = lib.lanczos_dia_round_write_bf16(
		w.data_ptr(), q_cur.data_ptr(), scal.data_ptr(), *fin, q_next.data_ptr(), nv, spec.ld, spec.lo, spec.n,
		float(residual_tol), gx, int(vec), stream(q_cur.device),
	)
	raise_on(lib, err, "lanczos_dia_round")
	count_launch("lanczos_dia_round", q_cur.dtype, vec)
	return q_next


def _check_round(name, q_cur, state, alpha_out, beta_out, spec) -> CarrySpec:
	nv = q_cur.shape[0]
	if q_cur.ndim != 2 or state.scal.shape != (5, nv) or alpha_out.shape != (nv,) or beta_out.shape != (nv,):
		raise ValueError(f"{name}: expected q_cur (nv, ld), the state (5, nv) and the outputs (nv,)")
	return _check_spec(name, spec, q_cur)


def _check_round_cuda(name, q_cur, state, alpha_out, beta_out, sums, **tensors) -> None:
	extra = {"sums": sums} if sums is not None else {}
	check_cuda(
		name, q_cur.dtype, q_cur.device, ("offsets",), bf16_only=True, acc_keys=("w", "scal", "alpha_out", "beta_out", "sums"),
		q_cur=q_cur, scal=state.scal, alpha_out=alpha_out, beta_out=beta_out, **extra, **tensors,
	)
	if state.ticket.device != q_cur.device or state.ticket.dtype != torch.int32 or state.ticket.numel() != 1:
		raise ValueError(f"{name}: the state's ticket must be one int32 on the operator's device")


def lanczos_dia_round(
	w: torch.Tensor, q_cur: torch.Tensor, state: LanczosState, alpha_out: torch.Tensor, beta_out: torch.Tensor,
	residual_tol: float, spec: Optional[CarrySpec] = None, reduce=None, sums: Optional[torch.Tensor] = None,
) -> torch.Tensor:
	"""The rest of a bfloat16 Lanczos step after pass A (see :func:`lanczos_round_ref`): on the card
	the round pair, B1 (``Σ(w − α·q)²``, then β', the outputs and the state) and B2 (``q_next``),
	with no host sync. ``w (nv, ld)`` float32 (pass A's, zero margins; overwritten on the CPU only),
	``q_cur (nv, ld)`` bfloat16 carries of layout ``spec`` (default the flat ``(nv, n)``), ``state``
	from :func:`lanczos_state` with α in ``state[ALPHA]`` and the done flags, ``alpha_out``/``beta_out``
	``(nv,)``. On a row-sharded carry give ``reduce`` (an in-place all-reduce of an ``(nv,)`` tensor)
	and ``sums (2, nv)`` float32 with the reduced α in ``sums[0]``: B1 writes the rank's Σv² to
	``sums[1]``, ``reduce`` finishes it, and B2 writes the outputs and the state from the reduced sums
	beside ``q_next`` (:func:`lanczos_round_pair_ref` on the CPU). Returns ``q_next (nv, ld)`` bfloat16,
	zero in the margins. bfloat16 only."""
	spec = _check_round("lanczos_dia_round", q_cur, state, alpha_out, beta_out, spec)
	if w.shape != q_cur.shape:
		raise ValueError("lanczos_dia_round: w must match q_cur (nv, ld)")
	if (reduce is None) != (sums is None) or (sums is not None and sums.shape != (2, q_cur.shape[0])):
		raise ValueError("lanczos_dia_round: a row-sharded carry takes both reduce and sums (2, nv), an unsharded one neither")
	if q_cur.device.type == "cpu":
		if sums is not None:
			return lanczos_round_pair_ref(w, q_cur, state, alpha_out, beta_out, residual_tol, spec, reduce, sums)
		return lanczos_dia_round_ref(w, q_cur, state, alpha_out, beta_out, residual_tol, spec)
	_check_round_cuda("lanczos_dia_round", q_cur, state, alpha_out, beta_out, sums, w=w)
	from ._build import load_library

	return _launch_round(load_library(), w, q_cur, state, alpha_out, beta_out, residual_tol, spec, reduce, sums)


def lanczos_dia_round_step(
	bands: torch.Tensor, offsets: torch.Tensor, q_cur: torch.Tensor, q_prev: torch.Tensor, state: LanczosState,
	alpha_out: torch.Tensor, beta_out: torch.Tensor, residual_tol: float, spec: Optional[CarrySpec] = None,
	reduce=None, rounded: bool = True,
) -> torch.Tensor:
	"""One whole Lanczos step of a bfloat16 sweep without re-orthogonalisation on a DIA operator
	(``primate_tpu/lanczos.py:304-316,378-388``): pass A (``w = A·q_cur − β·q_prev`` with β from
	``state[BETA]``, α; ``rounded`` as in :func:`lanczos_dia_step`), then :func:`lanczos_dia_round`.
	On the card three launches (pass A's last block writes α to ``state[ALPHA]``) and no PyTorch op;
	with ``reduce`` (a row-sharded carry) pass A writes the rank's α sums, ``reduce`` finishes them,
	and the round pair takes them and finishes the step: three launches too. ``q_cur``/``q_prev``
	``(nv, ld)`` bfloat16 carries of layout ``spec``, ``bands (n_d, ld)``. Returns ``q_next``."""
	_check_shapes("lanczos_dia_round_step", bands, offsets, q_cur)
	if q_prev.shape != q_cur.shape:
		raise ValueError("lanczos_dia_round_step: q_prev must match q_cur (nv, ld)")
	spec = _check_round("lanczos_dia_round_step", q_cur, state, alpha_out, beta_out, spec)
	s = state.scal
	if q_cur.device.type == "cpu":
		w, alpha = lanczos_dia_step_ref(bands, offsets, q_cur, q_prev, s[BETA], spec, reduce or _same, rounded)
		if reduce is not None:
			sums = torch.stack([alpha, torch.empty_like(alpha)])
			return lanczos_round_pair_ref(w, q_cur, state, alpha_out, beta_out, residual_tol, spec, reduce, sums)
		return spec.zero_margins(lanczos_round_ref(w, alpha, q_cur, state, alpha_out, beta_out, residual_tol, spec.rows))
	_check_round_cuda("lanczos_dia_round_step", q_cur, state, alpha_out, beta_out, None, bands=bands, offsets=offsets, q_prev=q_prev)
	from ._build import load_library

	lib = load_library()
	if reduce is None:
		w = _launch_pass_a(lib, bands, offsets, q_cur, q_prev, s, state.ticket, None, spec, rounded=rounded)[0]
		return _launch_round(lib, w, q_cur, state, alpha_out, beta_out, residual_tol, spec)
	sums = torch.empty((2, q_cur.shape[0]), dtype=torch.float32, device=q_cur.device)
	w = _launch_pass_a(lib, bands, offsets, q_cur, q_prev, s, state.ticket, None, spec, sums[0], rounded)[0]
	reduce(sums[0])
	return _launch_round(lib, w, q_cur, state, alpha_out, beta_out, residual_tol, spec, reduce, sums)


def lanczos_dia_step(
	bands: torch.Tensor, offsets: torch.Tensor, q_cur: torch.Tensor, q_prev: torch.Tensor, beta: torch.Tensor,
	spec: Optional[CarrySpec] = None, reduce=None, rounded: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
	"""Pass A of the Lanczos step alone, for a sweep that re-orthogonalises
	(``orth > 0``) or stores bfloat16: ``v = A·q_cur − β[:, None]·q_prev`` (zero outside the own
	rows) in the accumulation dtype and ``α = Re Σ_r conj(q_cur)·v`` over the own rows per probe,
	real (the kernel's partials summed by ``torch.sum``, then by ``reduce`` over a row-sharded
	carry's ranks). ``q_cur``/``q_prev`` ``(nv, ld)`` carries of layout ``spec`` (default flat
	``(nv, n)``), ``bands (n_d, ld)`` in the carry's columns, ``β (nv,)`` in the real accumulation
	dtype (float32 for complex64 and bfloat16). ``rounded``:
	round ``A·q_cur`` to the carry's dtype before the β-axpy (see :func:`lanczos_dia_step_ref`)."""
	_check_shapes("lanczos_dia_step", bands, offsets, q_cur)
	if q_prev.shape != q_cur.shape or beta.shape != (q_cur.shape[0],):
		raise ValueError("lanczos_dia_step: q_prev must match q_cur (nv, n) and beta be (nv,)")
	spec = _check_spec("lanczos_dia_step", spec, q_cur)
	_check_real("lanczos_dia_step", beta=beta)
	reduce = reduce or _same
	if q_cur.device.type == "cpu":
		return lanczos_dia_step_ref(bands, offsets, q_cur, q_prev, beta, spec, reduce, rounded)
	check_cuda(
		"lanczos_dia_step", q_cur.dtype, q_cur.device, ("offsets",), complex_ok=True, bf16_ok=True, acc_keys=("beta",),
		bands=bands, offsets=offsets, q_cur=q_cur, q_prev=q_prev, beta=beta,
	)
	from ._build import load_library

	ones, zeros = torch.ones_like(beta), torch.zeros_like(beta)
	scal = torch.stack([ones, ones, beta, zeros, zeros])  # rows DIV_CUR … ALPHA: q given normalised
	v, partial, _, _ = _launch_pass_a(load_library(), bands, offsets, q_cur, q_prev, scal, None, None, spec, rounded=rounded)
	return v, reduce(torch.sum(partial, dim=1))


def lanczos_dia_sweep_step(
	bands: torch.Tensor, offsets: torch.Tensor, v_cur: torch.Tensor, v_prev: torch.Tensor, state: LanczosState,
	alpha_out: torch.Tensor, beta_out: torch.Tensor, residual_tol: float, spec: Optional[CarrySpec] = None,
	reduce=None,
) -> torch.Tensor:
	"""One whole Lanczos step of a sweep without re-orthogonalisation on a DIA
	operator (see :func:`lanczos_sweep_step_ref` for what it computes): on the card
	two kernels, pass A (``lanczos_dia_step``) and pass B (``lanczos_dia_residual``),
	with no host sync. ``v_cur``/``v_prev`` ``(nv, ld)`` carries of layout ``spec`` (default
	the flat ``(nv, n)``), ``bands (n_d, ld)`` in the carry's columns, ``state`` from
	:func:`lanczos_state`, ``alpha_out``/``beta_out`` ``(nv,)`` (rows of the sweep's ``(deg, nv)``
	outputs). With ``reduce`` (a row-sharded carry: an in-place all-reduce of an ``(nv,)`` tensor
	over the ranks), the passes write only the rank's sums, ``reduce`` finishes each between the
	passes, and the step's finish (``alpha_out``, ``beta_out`` and the advanced state, from the
	reduced sums) is left pending in ``state.pending``: pass A of
	the next step runs it, or :func:`lanczos_dia_finish`, which the caller runs before it reads the
	state or the outputs. Two launches a step, two all-reduces of nv numbers (on the CPU
	:func:`lanczos_sharded_step_ref`). Complex64/complex128 carries take their own instantiations
	(unsharded only); the state, the outputs and the sums stay real. Returns the new residual block v."""
	_check_shapes("lanczos_dia_sweep_step", bands, offsets, v_cur)
	nv = v_cur.shape[0]
	if v_prev.shape != v_cur.shape or state.scal.shape != (5, nv) or alpha_out.shape != (nv,) or beta_out.shape != (nv,):
		raise ValueError("lanczos_dia_sweep_step: v_prev must match v_cur (nv, n), the state be (5, nv) and the outputs (nv,)")
	spec = _check_spec("lanczos_dia_sweep_step", spec, v_cur)
	_check_real("lanczos_dia_sweep_step", scal=state.scal, alpha_out=alpha_out, beta_out=beta_out)
	if v_cur.device.type == "cpu":
		apply_t = lambda q: dia_stencil_t_ref(bands, offsets, q)  # noqa: E731
		if reduce is not None:
			return lanczos_sharded_step_ref(apply_t, v_cur, v_prev, state, alpha_out, beta_out, residual_tol, reduce, spec)
		return lanczos_sweep_step_ref(apply_t, v_cur, v_prev, state, alpha_out, beta_out, residual_tol, spec=spec)
	check_cuda(
		"lanczos_dia_sweep_step", v_cur.dtype, v_cur.device, ("offsets",), complex_ok=True,
		acc_keys=("scal", "alpha_out", "beta_out"), bands=bands, offsets=offsets, v_cur=v_cur, v_prev=v_prev,
		scal=state.scal, alpha_out=alpha_out, beta_out=beta_out,
	)
	if state.ticket.device != v_cur.device or state.ticket.dtype != torch.int32 or state.ticket.numel() != 1:
		raise ValueError("lanczos_dia_sweep_step: the state's ticket must be one int32 on the operator's device")
	from ._build import load_library

	lib = load_library()
	if reduce is None:
		w, partial, gx, vec = _launch_pass_a(lib, bands, offsets, v_cur, v_prev, state.scal, state.ticket, alpha_out, spec)
		_launch_pass_b(lib, v_cur, w, state, partial, beta_out, residual_tol, gx, vec, spec)
		return w
	sums = torch.empty((2, nv), dtype=state.scal.dtype, device=v_cur.device)  # this step's own: the next pass A reads it
	pending = state.pending.pop() if state.pending else None
	w, partial, gx, vec = _launch_pass_a(
		lib, bands, offsets, v_cur, v_prev, state.scal, state.ticket, None, spec, sums[0], pending=pending
	)
	reduce(sums[0])
	_launch_pass_b(lib, v_cur, w, state, partial, beta_out, residual_tol, gx, vec, spec, sums)
	reduce(sums[1])
	state.pending.append(Finish(sums, alpha_out, beta_out, float(residual_tol)))
	return w


def dia_stencil(bands: torch.Tensor, offsets: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
	"""Node-major DIA stencil ``out[r, :] = Σ_d bands[d, r]·V[r + off_d, :]``.

	``bands (n_d, n)`` row-aligned, ``offsets (n_d,)`` int64, ``V (n, k)``
	contiguous (node-major); any offsets and any ``k``.
	"""
	if V.ndim != 2 or bands.ndim != 2 or offsets.ndim != 1:
		raise ValueError("dia_stencil: expected V (n, k), bands (n_d, n), offsets (n_d,)")
	if bands.shape != (offsets.shape[0], V.shape[0]):
		raise ValueError(f"dia_stencil: bands {tuple(bands.shape)} do not match offsets {tuple(offsets.shape)} and n={V.shape[0]}")
	if V.device.type == "cpu":
		return dia_stencil_ref(bands, offsets, V)
	bands, V = resolved(bands), resolved(V)
	check_cuda("dia_stencil", V.dtype, V.device, ("offsets",), complex_ok=True, bf16_ok=True, bands=bands, offsets=offsets, V=V)
	from ._build import load_library

	lib = load_library()
	n, k = V.shape
	out = torch.empty_like(V)
	vec = vector_ok(k, V.element_size(), V, out)
	fn = getattr(lib, f"dia_stencil_{SUFFIX[V.dtype]}")
	err = fn(bands.data_ptr(), offsets.data_ptr(), bands.shape[0], V.data_ptr(), out.data_ptr(), n, k, int(vec), stream(V.device))
	raise_on(lib, err, "dia_stencil")
	count_launch("dia_stencil", V.dtype, vec)
	return out
