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
  contiguous ``(n, k)`` block (a QR factor, a GEMM product). Its blocks stage a
  ring of V rows in shared memory, so the nearby diagonals read each row once;
  16-byte vectors along k where ``k`` and the pointers allow, elements otherwise
  (counted in ``SCALAR_LAUNCHES``).
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

All are bound by HBM bytes (a few flops per loaded element); the kernels make
one pass over the probe block and bounds-check the ragged edges, so neither the
TPU's zero-padded halo copy nor its 128-lane offset limit and ``k % 128`` rule
carries over.

Each wrapper runs its plain version (``*_ref``) only for tensors on the CPU. For
a CUDA tensor it launches the kernel or raises; it counts each launch in
:data:`LAUNCHES`.
"""

from typing import NamedTuple, Tuple

import torch

from ._common import LAUNCHES, SCALAR_LAUNCHES, SUFFIX, acc_dtype, check_cuda, raise_on, reset_launches, stream, vector_ok

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
	"row_dot",
	"row_sq_norm",
	"lanczos_state",
	"lanczos_dia_sweep_step",
	"lanczos_sweep_step_ref",
	"lanczos_sweep_pass_a_ref",
	"lanczos_sweep_pass_b_ref",
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


def dia_stencil_t_ref(bands: torch.Tensor, offsets: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
	"""Plain version of :func:`dia_stencil_t`: ``out[b, r] = Σ_d bands[d, r]·x[b, r + off_d]``,
	accumulated in ``promote_types(dtype, float32)`` and returned in ``x.dtype``."""
	nv, n = x.shape
	acc = acc_dtype(x.dtype)
	out = torch.zeros((nv, n), dtype=acc, device=x.device)
	for d, off in enumerate(offsets.tolist()):
		lo, hi = max(0, -off), min(n, n - off)
		if lo < hi:
			out[:, lo:hi] += bands[d, lo:hi].to(acc) * x[:, lo + off : hi + off].to(acc)
	return out.to(x.dtype)


def row_dot(X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
	"""``Re Σ_r conj(X[b, r])·Y[b, r]`` per row (``Σ X·Y`` for real blocks): the real inner
	products of a Hermitian Lanczos step (``primate_tpu/lanczos.py:312-315``)."""
	return torch.real(torch.sum(X.conj() * Y, dim=1)) if X.is_complex() else torch.sum(Y * X, dim=1)


def row_sq_norm(X: torch.Tensor) -> torch.Tensor:
	"""``Σ_r |X[b, r]|²`` per row, real."""
	return torch.sum(torch.view_as_real(X).square(), dim=(1, 2)) if X.is_complex() else torch.sum(X * X, dim=1)


def lanczos_dia_step_ref(
	bands: torch.Tensor, offsets: torch.Tensor, q_cur: torch.Tensor, q_prev: torch.Tensor, beta: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
	"""Plain version of :func:`lanczos_dia_step`: ``v = A·q_cur − β·q_prev`` and
	``α = Σ_r v·q_cur``, both in the accumulation dtype (``primate_tpu/lanczos.py:309-315``)."""
	acc = acc_dtype(q_cur.dtype)
	v = dia_stencil_t_ref(bands, offsets, q_cur).to(acc) - beta[:, None].to(acc) * q_prev.to(acc)
	alpha = torch.sum(v * q_cur.to(acc), dim=1)
	return v, alpha


# Rows of a sweep's per-probe state, as the step kernels read and update them
# (``csrc/dia_stencil.cu``): the guarded divisors of the carried residuals
# (q = v / div), the coupling β, the done flags (0 or 1) and the step's α.
DIV_CUR, DIV_PREV, BETA, DONE, ALPHA = range(5)


class LanczosState(NamedTuple):
	"""What a sweep carries from step to step besides its two residual blocks:
	``scal (5, nv)`` in the accumulation dtype (rows :data:`DIV_CUR` … :data:`ALPHA`),
	updated in place by each step, and ``ticket (1,)`` int32, a counter the kernels
	use to find the last block of a pass; it is 0 between launches."""

	scal: torch.Tensor
	ticket: torch.Tensor


def lanczos_state(nv: int, dtype: torch.dtype, device) -> LanczosState:
	"""The state before the first step: q = v (divisors 1), β = 0, nothing done."""
	scal = torch.zeros((5, nv), dtype=dtype, device=device)
	scal[DIV_CUR] = 1
	scal[DIV_PREV] = 1
	return LanczosState(scal, torch.zeros(1, dtype=torch.int32, device=device))


def _same(x):
	return x


def lanczos_sweep_pass_a_ref(
	apply_t, v_cur: torch.Tensor, v_prev: torch.Tensor, state: LanczosState, alpha_out: torch.Tensor,
	reduce=_same, rows=_same,
) -> torch.Tensor:
	"""Plain version of pass A: with ``q = v_cur / div_cur`` and ``q_prev = v_prev / div_prev``,
	returns ``w = A q − β q_prev``; writes ``α = Re Σ conj(q)·w`` (``Σ w q`` for real blocks) to
	``state.scal[ALPHA]`` and to ``alpha_out`` (zero where a probe is done). The state is real
	for complex (Hermitian) blocks too. On a row-sharded carry ``rows`` picks the rank's rows and
	``reduce`` finishes the sum over the other ranks' (identities otherwise)."""
	s = state.scal
	q = v_cur / s[DIV_CUR, :, None]
	w = apply_t(q).to(v_cur.dtype) - s[BETA, :, None] * (v_prev / s[DIV_PREV, :, None])
	alpha = reduce(row_dot(rows(q), rows(w)))
	alpha_out.copy_(torch.where(s[DONE] != 0, 0.0, alpha))
	s[ALPHA] = alpha
	return w


def lanczos_sweep_pass_b_ref(
	v_cur: torch.Tensor, w: torch.Tensor, state: LanczosState, beta_out: torch.Tensor, residual_tol: float,
	reduce=_same, rows=_same,
) -> torch.Tensor:
	"""Plain version of pass B: ``v = w − α q`` in place of ``w``, ``β' = ‖v‖`` (``√Σ|v|²``); writes
	``beta_out`` (zero where a probe was done) and advances ``state``: ``div_prev = div_cur``,
	``div_cur = β'`` if ``β' > residual_tol`` else ``inf``, ``β = β'``, ``done |= β' < residual_tol``.
	``reduce`` and ``rows`` as in pass A."""
	s = state.scal
	v = w.sub_(s[ALPHA, :, None] * (v_cur / s[DIV_CUR, :, None]))
	beta = torch.sqrt(reduce(row_sq_norm(rows(v))))
	done = s[DONE] != 0
	beta_out.copy_(torch.where(done, 0.0, beta))
	s[DIV_PREV] = s[DIV_CUR]
	s[DIV_CUR] = torch.where(beta > residual_tol, beta, torch.inf)
	s[BETA] = beta
	s[DONE] = (done | (beta < residual_tol)).to(s.dtype)
	return v


def lanczos_sweep_step_ref(
	apply_t, v_cur: torch.Tensor, v_prev: torch.Tensor, state: LanczosState, alpha_out: torch.Tensor,
	beta_out: torch.Tensor, residual_tol: float, reduce=_same, rows=_same,
) -> torch.Tensor:
	"""Plain version of :func:`lanczos_dia_sweep_step`, for any probe-major apply
	``apply_t`` (``primate_tpu/lanczos.py:304-316,378-388`` with ``orth = 0``): pass A
	then pass B. The next step's ``q = v / div_cur`` is the reference's guarded ``v / β'``.
	``reduce`` and ``rows`` route the two sums of a row-sharded carry (see pass A)."""
	w = lanczos_sweep_pass_a_ref(apply_t, v_cur, v_prev, state, alpha_out, reduce, rows)
	return lanczos_sweep_pass_b_ref(v_cur, w, state, beta_out, residual_tol, reduce, rows)




def _check_shapes(name: str, bands: torch.Tensor, offsets: torch.Tensor, x: torch.Tensor) -> None:
	if x.ndim != 2 or bands.ndim != 2 or offsets.ndim != 1:
		raise ValueError(f"{name}: expected x (nv, n), bands (n_d, n), offsets (n_d,)")
	if bands.shape != (offsets.shape[0], x.shape[1]):
		raise ValueError(f"{name}: bands {tuple(bands.shape)} do not match offsets {tuple(offsets.shape)} and n={x.shape[1]}")


def dia_stencil_t(bands: torch.Tensor, offsets: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
	"""Probe-major DIA stencil ``out[b, r] = Σ_d bands[d, r]·x[b, r + off_d]``.

	``bands (n_d, n)`` row-aligned, ``offsets (n_d,)`` int64, ``x (nv, n)``; any offsets.
	"""
	_check_shapes("dia_stencil_t", bands, offsets, x)
	if x.device.type == "cpu":
		return dia_stencil_t_ref(bands, offsets, x)
	check_cuda("dia_stencil_t", x.dtype, x.device, ("offsets",), complex_ok=True, bands=bands, offsets=offsets, x=x)
	from ._build import load_library

	lib = load_library()
	nv, n = x.shape
	out = torch.empty_like(x)
	vec = vector_ok(n, x.element_size(), x, out)
	fn = getattr(lib, f"dia_stencil_t_{SUFFIX[x.dtype]}")
	err = fn(bands.data_ptr(), offsets.data_ptr(), bands.shape[0], x.data_ptr(), out.data_ptr(), nv, n, int(vec), stream(x.device))
	raise_on(lib, err, "dia_stencil_t")
	LAUNCHES["dia_stencil_t"] += 1
	SCALAR_LAUNCHES["dia_stencil_t"] += not vec
	return out


def _launch_pass_a(lib, bands, offsets, v_cur, v_prev, scal, ticket, alpha_out):
	"""Pass A on the card: returns w and the (nv, grid) α partials."""
	nv, n = v_cur.shape
	gx = lib.lanczos_step_blocks(nv, n, v_cur.element_size())
	if gx < 1:
		raise RuntimeError("lanczos_dia_step: could not query the CUDA device for the grid size")
	w = torch.empty_like(v_cur)
	partial = torch.empty((nv, gx), dtype=v_cur.dtype, device=v_cur.device)
	vec = vector_ok(n, v_cur.element_size(), bands, v_cur, v_prev, w)
	fn = lib.lanczos_dia_step_f32 if v_cur.dtype == torch.float32 else lib.lanczos_dia_step_f64
	err = fn(
		bands.data_ptr(), offsets.data_ptr(), bands.shape[0], v_cur.data_ptr(), v_prev.data_ptr(), scal.data_ptr(),
		w.data_ptr(), partial.data_ptr(), ticket.data_ptr() if ticket is not None else None,
		alpha_out.data_ptr() if alpha_out is not None else None, nv, n, gx, int(vec), stream(v_cur.device),
	)
	raise_on(lib, err, "lanczos_dia_step")
	LAUNCHES["lanczos_dia_step"] += 1
	SCALAR_LAUNCHES["lanczos_dia_step"] += not vec
	return w, partial, gx, vec


def _launch_pass_b(lib, v_cur, w, state, partial, beta_out, residual_tol, gx, vec) -> None:
	"""Pass B on the card, on pass A's w (in place) and partials buffer."""
	nv, n = v_cur.shape
	fn = lib.lanczos_dia_residual_f32 if v_cur.dtype == torch.float32 else lib.lanczos_dia_residual_f64
	err = fn(
		v_cur.data_ptr(), w.data_ptr(), state.scal.data_ptr(), partial.data_ptr(), state.ticket.data_ptr(),
		beta_out.data_ptr(), nv, n, float(residual_tol), gx, int(vec), stream(v_cur.device),
	)
	raise_on(lib, err, "lanczos_dia_residual")
	LAUNCHES["lanczos_dia_residual"] += 1
	SCALAR_LAUNCHES["lanczos_dia_residual"] += not vec


def lanczos_dia_step(
	bands: torch.Tensor, offsets: torch.Tensor, q_cur: torch.Tensor, q_prev: torch.Tensor, beta: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
	"""Pass A of the Lanczos step alone, for a sweep that re-orthogonalises
	(``orth > 0``): ``v = A·q_cur − β[:, None]·q_prev`` and ``α = Σ_r v·q_cur`` per
	probe (the kernel's partials summed by ``torch.sum``). ``q_cur``/``q_prev``
	``(nv, n)``, ``β (nv,)``."""
	_check_shapes("lanczos_dia_step", bands, offsets, q_cur)
	if q_prev.shape != q_cur.shape or beta.shape != (q_cur.shape[0],):
		raise ValueError("lanczos_dia_step: q_prev must match q_cur (nv, n) and beta be (nv,)")
	if q_cur.device.type == "cpu":
		return lanczos_dia_step_ref(bands, offsets, q_cur, q_prev, beta)
	check_cuda(
		"lanczos_dia_step", q_cur.dtype, q_cur.device, ("offsets",), bands=bands, offsets=offsets, q_cur=q_cur, q_prev=q_prev, beta=beta
	)
	from ._build import load_library

	ones, zeros = torch.ones_like(beta), torch.zeros_like(beta)
	scal = torch.stack([ones, ones, beta, zeros, zeros])  # rows DIV_CUR … ALPHA: q given normalised
	v, partial, _, _ = _launch_pass_a(load_library(), bands, offsets, q_cur, q_prev, scal, None, None)
	return v, torch.sum(partial, dim=1)


def lanczos_dia_sweep_step(
	bands: torch.Tensor, offsets: torch.Tensor, v_cur: torch.Tensor, v_prev: torch.Tensor, state: LanczosState,
	alpha_out: torch.Tensor, beta_out: torch.Tensor, residual_tol: float,
) -> torch.Tensor:
	"""One whole Lanczos step of a sweep without re-orthogonalisation on a DIA
	operator (see :func:`lanczos_sweep_step_ref` for what it computes): on the card
	two kernels, pass A (``lanczos_dia_step``) and pass B (``lanczos_dia_residual``),
	with no host sync. ``v_cur``/``v_prev`` ``(nv, n)``, ``state`` from
	:func:`lanczos_state`, ``alpha_out``/``beta_out`` ``(nv,)`` (rows of the sweep's
	``(deg, nv)`` outputs). Returns the new residual block v."""
	_check_shapes("lanczos_dia_sweep_step", bands, offsets, v_cur)
	nv = v_cur.shape[0]
	if v_prev.shape != v_cur.shape or state.scal.shape != (5, nv) or alpha_out.shape != (nv,) or beta_out.shape != (nv,):
		raise ValueError("lanczos_dia_sweep_step: v_prev must match v_cur (nv, n), the state be (5, nv) and the outputs (nv,)")
	if v_cur.device.type == "cpu":
		return lanczos_sweep_step_ref(
			lambda q: dia_stencil_t_ref(bands, offsets, q), v_cur, v_prev, state, alpha_out, beta_out, residual_tol
		)
	check_cuda(
		"lanczos_dia_sweep_step", v_cur.dtype, v_cur.device, ("offsets",), bands=bands, offsets=offsets, v_cur=v_cur,
		v_prev=v_prev, scal=state.scal, alpha_out=alpha_out, beta_out=beta_out,
	)
	if state.ticket.device != v_cur.device or state.ticket.dtype != torch.int32 or state.ticket.numel() != 1:
		raise ValueError("lanczos_dia_sweep_step: the state's ticket must be one int32 on the operator's device")
	from ._build import load_library

	lib = load_library()
	w, partial, gx, vec = _launch_pass_a(lib, bands, offsets, v_cur, v_prev, state.scal, state.ticket, alpha_out)
	_launch_pass_b(lib, v_cur, w, state, partial, beta_out, residual_tol, gx, vec)
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
	check_cuda("dia_stencil", V.dtype, V.device, ("offsets",), complex_ok=True, bands=bands, offsets=offsets, V=V)
	from ._build import load_library

	lib = load_library()
	n, k = V.shape
	out = torch.empty_like(V)
	vec = vector_ok(k, V.element_size(), V, out)
	fn = getattr(lib, f"dia_stencil_{SUFFIX[V.dtype]}")
	err = fn(bands.data_ptr(), offsets.data_ptr(), bands.shape[0], V.data_ptr(), out.data_ptr(), n, k, int(vec), stream(V.device))
	raise_on(lib, err, "dia_stencil")
	LAUNCHES["dia_stencil"] += 1
	SCALAR_LAUNCHES["dia_stencil"] += not vec
	return out
