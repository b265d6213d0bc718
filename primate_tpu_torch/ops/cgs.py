"""The CGS window of the re-orthogonalised Lanczos step: the step's tail after pass A.

``v −= α·q_cur``, then ``reorth_passes`` passes of classical Gram–Schmidt against the valid slots of
the basis window (``proj = Qᴴ v``, ``v −= Q proj``; ``primate_tpu/lanczos.py:294-301``), then
``Σ|v|²`` for β. :class:`CgsWindow` runs it for one sweep: on the card a chain of hand-written
kernels (``csrc/cgs_window.cu``) that reads each valid slot once a pass and writes no
``(ncv, nv, n)`` temporary, r + 1 launches at ``reorth_passes = r`` where a launch's slots fit its
registers (:data:`KHOLD`); on the CPU :func:`cgs_window_ref`, the PyTorch ops the sweep ran before.
The sums between launches go through the sweep's ``reduce`` (an all-reduce on a row-sharded carry).

The valid slots are a bitmask the host computes from the step (:func:`slot_mask`), not a tensor.
Each call that starts a step (one given ``alpha``) counts one launch of ``"cgs_window"`` in
:data:`~primate_tpu_torch.ops._common.LAUNCHES`, and in ``SCALAR_LAUNCHES`` where its kernels took
element loads, however many kernels the chain launched.
"""

from typing import List, Optional, Tuple

import torch

from ._common import SUFFIX, count_launch, raise_on, stream
from .dia import row_sq_norm

__all__ = ["KHOLD", "CgsWindow", "cgs_window_ref", "slot_mask", "slot_groups"]

# Slots one kernel launch takes (``kHold`` in ``csrc/cgs_window.cu``).
KHOLD = 8
# The (carry, window, q_cur) dtypes the kernels take, by their entry points' suffixes: a carry in the
# accumulation dtype; a window in the carry's dtype, in another real (or complex) width, or bfloat16 or
# float16 (a real sweep's ``basis_dtype``); q_cur in the sweep's dtype (bfloat16 for a bfloat16 sweep, whose
# carry is float32). These are every window ``lanczos._basis_dtype`` lets a sweep keep.
COMBOS = (
	"f32_f32_f32", "f32_bf16_bf16", "f32_bf16_f32", "f32_f32_bf16", "f32_f64_f32", "f32_f64_bf16", "f32_f16_f32",
	"f32_f16_bf16", "f64_f64_f64", "f64_f32_f64", "f64_bf16_f64", "f64_f16_f64", "c64_c64_c64", "c64_c128_c64",
	"c128_c128_c128", "c128_c64_c128",
)
_SUFFIX = {**SUFFIX, torch.float16: "f16"}
# Real sums a probe at most in one launch (the kernels' kSums): complex dots of KHOLD slots and Σ|v|².
_SUMS = 2 * KHOLD + 1


def _same(x):
	return x


def slot_mask(j: int, orth: int, ncv: int, selective: bool = False) -> int:
	"""The window slots step ``j`` projects out, as a bitmask (bit ``s`` for slot ``s``): slot ``s``
	holds ``q_t`` with ``t ≡ s (mod ncv)``, of age ``(j − s) mod ncv``; a slot is valid once written
	(age ≤ j) and, but for selective re-orthogonalisation, while its age is below ``orth``."""
	mask = 0
	for s in range(ncv):
		age = (j - s) % ncv
		if age <= j and (selective or age < orth):
			mask |= 1 << s
	return mask


def slot_groups(mask: int, ncv: int, top: Optional[int] = None) -> List[Tuple[int, int]]:
	"""The launches' slots of ``mask``, newest first: ``(bits, top)`` pairs, bit ``b`` of ``bits`` for
	slot ``top − b`` (mod ``ncv``), each at most :data:`KHOLD` slots within 64 of its ``top``. The walk
	starts at ``top`` (default: a valid slot whose successor is not, the newest of a window's valid
	run, or the last slot of a full mask), so a window's valid slots are the low bits of its first launch."""
	if top is None:
		valid = [s for s in range(ncv) if (mask >> s) & 1]
		top = next((s for s in valid if not (mask >> ((s + 1) % ncv)) & 1), ncv - 1)
	groups, bits, first = [], 0, 0
	for age in range(ncv):
		if not (mask >> ((top - age) % ncv)) & 1:
			continue
		if bits and (bin(bits).count("1") == KHOLD or age - first >= 64):
			groups.append((bits, (top - first) % ncv))
			bits = 0
		if not bits:
			first = age
		bits |= 1 << (age - first)
	if bits:
		groups.append((bits, (top - first) % ncv))
	return groups


def cgs_window_ref(
	v: torch.Tensor, Q_win: torch.Tensor, mask: int, passes: int, alpha: Optional[torch.Tensor] = None,
	q: Optional[torch.Tensor] = None, reduce=_same,
) -> torch.Tensor:
	"""Plain version of the chain, in place on ``v (nv, n)`` (the carry's rows, in the accumulation
	dtype): ``v −= α·q`` where ``alpha`` is given (``q (nv, n)`` in the sweep's dtype), then ``passes``
	CGS passes (at least one) against the slots of ``mask`` of ``Q_win (ncv, nv, n)`` where ``mask``
	has any, broadcast products and sums over n (no matmul, so TF32 never comes into it); returns
	``Σ|v|²`` per probe, each sum over n finished by ``reduce``."""
	if alpha is not None:
		v.addcmul_(alpha[:, None], q.to(v.dtype), value=-1)
	if mask:
		valid = torch.tensor([(mask >> s) & 1 for s in range(Q_win.shape[0])], dtype=v.real.dtype, device=v.device)
		Q_bra = Q_win.conj() if Q_win.is_complex() else Q_win
		for _ in range(max(1, passes)):
			proj = reduce(torch.sum(Q_bra * v[None, :, :], dim=2)) * valid[:, None]
			v.sub_(torch.sum(Q_win * proj[:, :, None].to(v.dtype), dim=0))
	return reduce(row_sq_norm(v))


def _vec_ok(t: torch.Tensor, elems: int) -> bool:
	"""Whether ``t``'s rows (``elems`` a thread) allow 16-byte accesses: its row stride and start whole vectors."""
	vl = 16 // t.element_size()
	return t.data_ptr() % 16 == 0 and t.stride(-2) % vl == 0 and elems % vl == 0


class CgsWindow:
	"""The CGS window of one sweep over the basis window ``Q_win (ncv, nv, n)``, whose rows the sweep's
	carried rows match; ``reduce`` finishes a sum over n (the sweep's ``layout.reduce_rows``).

	``window(v, mask, passes, alpha, q, q_slot)`` runs the tail of a step in place on ``v (nv, n)`` (the
	carry's rows in the accumulation dtype; any row stride) and returns the reduced ``Σ|v|²``: ``v −= α·q``
	where ``alpha`` is given, then ``passes`` CGS passes against the slots of ``mask`` where it has any
	(:func:`cgs_window_ref`). ``q`` is ``q_cur``'s rows; or ``q_slot`` names the window's slot that holds
	``q_cur`` exactly (``q`` then not given), and the kernels take it from the slot they read anyway. A CPU
	window runs :func:`cgs_window_ref`; a CUDA one launches the kernels or raises."""

	def __init__(self, Q_win: torch.Tensor, reduce=_same):
		self.Q, self.reduce = Q_win, reduce
		self._work = None

	def __call__(
		self, v: torch.Tensor, mask: int, passes: int, alpha: Optional[torch.Tensor] = None, q: Optional[torch.Tensor] = None,
		q_slot: int = -1,
	) -> torch.Tensor:
		if q_slot >= 0:
			q = self.Q[q_slot]
		if v.device.type == "cpu":
			return cgs_window_ref(v, self.Q, mask, passes, alpha, q, self.reduce)
		return self._chain(v, mask, max(1, passes) if mask else 0, alpha, q, q_slot)

	# -- the card -----------------------------------------------------------------------------------
	def _check(self, v, alpha, q) -> str:
		Q = self.Q
		ncv, nv, n = Q.shape
		if v.dtype not in (torch.float32, torch.float64, torch.complex64, torch.complex128):
			raise TypeError(f"cgs_window: the carry must be float32, float64, complex64 or complex128; got {v.dtype}")
		if v.shape != (nv, n) or v.stride(1) != 1 or not Q.is_contiguous() or Q.device != v.device:
			raise ValueError("cgs_window: v must be (nv, n) rows of unit stride beside a contiguous window (ncv, nv, n) on its device")
		qd = v.dtype if q is None else q.dtype
		combo = f"{_SUFFIX[v.dtype]}_{_SUFFIX.get(Q.dtype, Q.dtype)}_{_SUFFIX.get(qd, qd)}"
		if combo not in COMBOS:
			raise TypeError(f"cgs_window: no kernel takes a {v.dtype} carry with a {Q.dtype} window and a {qd} q_cur")
		if alpha is not None:
			if q is None or q.shape != (nv, n) or q.stride(1) != 1 or q.device != v.device:
				raise ValueError("cgs_window: the alpha step needs q_cur's rows (nv, n) of unit stride on the carry's device")
			if alpha.shape != (nv,) or alpha.dtype != v.real.dtype or not alpha.is_contiguous():
				raise TypeError(f"cgs_window: alpha must be ({nv},) {v.real.dtype}")
		return combo

	def _launcher(self, v, alpha, q, q_slot: int = -1):
		"""``(launch, vec)`` for a step's tail on ``v``: ``launch(group, alpha, proj_in, proj_out, sq)`` runs one
		kernel of the chain over the slots ``group`` (a ``(bits, top)`` of :func:`slot_groups`), and ``vec``
		says whether the kernels take 16-byte accesses. ``q`` is q_cur's rows: the window's slot ``q_slot`` where
		that is given, which the launch holding that slot first reads in place of ``q``."""
		from ._build import load_library

		combo = self._check(v, alpha, q)
		lib = load_library("cgs_window")
		Q = self.Q
		ncv, nv, n = Q.shape
		wide = torch.promote_types(v.dtype, Q.dtype)
		if self._work is None or self._work[0] != combo:
			gx = getattr(lib, f"cgs_window_blocks_{combo}")(nv, n)
			if gx < 1:
				raise RuntimeError("cgs_window: could not query the CUDA device for the grid size")
			partial = torch.empty(nv * _SUMS * gx, dtype=wide.to_real(), device=v.device)
			self._work = (combo, gx, partial, torch.zeros(1, dtype=torch.int32, device=v.device))
		_, gx, partial, ticket = self._work
		elems = max(16 // t.element_size() for t in (v, Q, q if q is not None else v))
		vec = n % elems == 0 and _vec_ok(v, elems) and _vec_ok(Q[0], elems) and (q is None or q_slot >= 0 or _vec_ok(q, elems))
		fn = getattr(lib, f"cgs_window_{combo}")

		def launch(group=(0, 0), alpha=None, proj_in=None, proj_out=None, sq=None):
			bits, top = group
			ptr = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
			# With α, q_cur comes from the launch's first slot where that is its window slot.
			q_ptr, ld_q = (None, 0) if alpha is None or (q_slot == top and bits & 1) else (q.data_ptr(), q.stride(0))
			err = fn(
				v.data_ptr(), v.stride(0), q_ptr, ld_q, ptr(alpha), Q.data_ptr(), bits, top, ncv, ptr(proj_in), ptr(proj_out),
				ptr(sq), partial.data_ptr(), ticket.data_ptr(), nv, n, gx, int(vec), stream(v.device),
			)
			raise_on(lib, err, "cgs_window")

		return launch, vec

	def _chain(self, v, mask, passes, alpha, q, q_slot) -> torch.Tensor:
		ncv, nv, _ = self.Q.shape
		wide = torch.promote_types(v.dtype, self.Q.dtype)
		launch, vec = self._launcher(v, alpha, q, q_slot)
		new_proj = lambda: torch.empty((ncv, nv), dtype=wide, device=v.device)  # noqa: E731
		sq = torch.empty(nv, dtype=v.real.dtype, device=v.device)
		groups = slot_groups(mask, ncv, q_slot if q_slot >= 0 and (mask >> q_slot) & 1 else None) if passes else []
		if not groups:
			launch(alpha=alpha, sq=sq)
		elif len(groups) == 1:
			# K1: α and the first dots; then each pass's update and the next dots in one read; the last update and Σ|v|².
			g = groups[0]
			proj = new_proj()
			launch(g, alpha, proj_out=proj)
			for _ in range(passes - 1):
				nxt = new_proj()
				launch(g, proj_in=self.reduce(proj), proj_out=nxt)
				proj = nxt
			launch(g, proj_in=self.reduce(proj), sq=sq)
		else:
			# More slots than a launch holds: each group's dots on the same v, then each group's update.
			proj = new_proj()
			for i, g in enumerate(groups):
				launch(g, alpha if i == 0 else None, proj_out=proj)
			for p in range(passes):
				proj = self.reduce(proj)
				last = p == passes - 1
				for i, g in enumerate(groups):
					launch(g, proj_in=proj, sq=sq if last and i == len(groups) - 1 else None)
				if not last:
					proj = new_proj()
					for g in groups:
						launch(g, proj_out=proj)
		if alpha is not None:
			count_launch("cgs_window", v.dtype, vec)
		return self.reduce(sq)
