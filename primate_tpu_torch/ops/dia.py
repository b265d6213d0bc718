"""DIA stencil kernels: wrappers, plain PyTorch versions, launch counts.

Three hand-written CUDA kernels (``csrc/dia_stencil.cu``) replace the Pallas TPU
kernels of ``primate_tpu/ops/dia_pallas.py``:

* :func:`dia_stencil_t` replaces ``dia_matmat_t_pallas`` (``_dia_t_kernel``):
  ``out[b, r] = Σ_d bands[d, r] · X[b, r + off_d]``, probe-major. It is
  ``DIAOperator.matmat_t``, the quadratic forms of a plain DIA operator, and the
  node-major apply of a block whose transpose is contiguous.
* :func:`dia_stencil` replaces ``dia_matmat_pallas`` (``_dia_kernel``):
  ``out[r, :] = Σ_d bands[d, r] · V[r + off_d, :]``, node-major, the apply of a
  contiguous ``(n, k)`` block (a QR factor, a GEMM product).
* :func:`lanczos_dia_step` replaces ``dia_matmat_t_phys`` (``_dia_t_phys_kernel``),
  the stencil of the Lanczos sweep. On the TPU a ``pallas_call`` could not join
  XLA's fusion of the stencil with the β-axpy and the α reduction
  (``primate_tpu/lanczos.py:101-104``); here one kernel does all three:
  ``v = A·q_cur − β·q_prev`` and per-block partial sums of ``v·q_cur``, which the
  wrapper adds up to α (no atomics, so α is deterministic).

All are bound by HBM bytes (a few flops per loaded element); the kernels make
one pass over the probe block and bounds-check the ragged edges, so neither the
TPU's zero-padded halo copy nor its 128-lane offset limit and ``k % 128`` rule
carries over.

Each wrapper runs its plain version (``*_ref``) only for tensors on the CPU. For
a CUDA tensor it launches the kernel or raises; it counts each launch in
:data:`LAUNCHES`.
"""

from typing import Tuple

import torch

from ._common import LAUNCHES, acc_dtype, check_cuda, raise_on, reset_launches, stream

__all__ = [
	"LAUNCHES",
	"reset_launches",
	"dia_stencil",
	"dia_stencil_ref",
	"dia_stencil_t",
	"dia_stencil_t_ref",
	"lanczos_dia_step",
	"lanczos_dia_step_ref",
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


def lanczos_dia_step_ref(
	bands: torch.Tensor, offsets: torch.Tensor, q_cur: torch.Tensor, q_prev: torch.Tensor, beta: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
	"""Plain version of :func:`lanczos_dia_step`: ``v = A·q_cur − β·q_prev`` and
	``α = Σ_r v·q_cur``, both in the accumulation dtype (``primate_tpu/lanczos.py:309-315``)."""
	acc = acc_dtype(q_cur.dtype)
	v = dia_stencil_t_ref(bands, offsets, q_cur).to(acc) - beta[:, None].to(acc) * q_prev.to(acc)
	alpha = torch.sum(v * q_cur.to(acc), dim=1)
	return v, alpha


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
	check_cuda("dia_stencil_t", x.dtype, x.device, ("offsets",), bands=bands, offsets=offsets, x=x)
	from ._build import load_library

	lib = load_library()
	nv, n = x.shape
	out = torch.empty_like(x)
	fn = lib.dia_stencil_t_f32 if x.dtype == torch.float32 else lib.dia_stencil_t_f64
	err = fn(bands.data_ptr(), offsets.data_ptr(), bands.shape[0], x.data_ptr(), out.data_ptr(), nv, n, stream(x.device))
	raise_on(lib, err, "dia_stencil_t")
	LAUNCHES["dia_stencil_t"] += 1
	return out


def lanczos_dia_step(
	bands: torch.Tensor, offsets: torch.Tensor, q_cur: torch.Tensor, q_prev: torch.Tensor, beta: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
	"""One fused Lanczos step on a DIA operator: ``v = A·q_cur − β[:, None]·q_prev``
	and ``α = Σ_r v·q_cur`` per probe. ``q_cur``/``q_prev`` ``(nv, n)``, ``β (nv,)``."""
	_check_shapes("lanczos_dia_step", bands, offsets, q_cur)
	if q_prev.shape != q_cur.shape or beta.shape != (q_cur.shape[0],):
		raise ValueError("lanczos_dia_step: q_prev must match q_cur (nv, n) and beta be (nv,)")
	if q_cur.device.type == "cpu":
		return lanczos_dia_step_ref(bands, offsets, q_cur, q_prev, beta)
	check_cuda(
		"lanczos_dia_step", q_cur.dtype, q_cur.device, ("offsets",), bands=bands, offsets=offsets, q_cur=q_cur, q_prev=q_prev, beta=beta
	)
	from ._build import load_library

	lib = load_library()
	nv, n = q_cur.shape
	v = torch.empty_like(q_cur)
	partial = torch.empty((nv, lib.lanczos_dia_step_partials(n)), dtype=q_cur.dtype, device=q_cur.device)
	fn = lib.lanczos_dia_step_f32 if q_cur.dtype == torch.float32 else lib.lanczos_dia_step_f64
	err = fn(
		bands.data_ptr(), offsets.data_ptr(), bands.shape[0], q_cur.data_ptr(), q_prev.data_ptr(), beta.data_ptr(),
		v.data_ptr(), partial.data_ptr(), nv, n, stream(q_cur.device),
	)
	raise_on(lib, err, "lanczos_dia_step")
	LAUNCHES["lanczos_dia_step"] += 1
	return v, torch.sum(partial, dim=1)


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
	check_cuda("dia_stencil", V.dtype, V.device, ("offsets",), bands=bands, offsets=offsets, V=V)
	from ._build import load_library

	lib = load_library()
	n, k = V.shape
	out = torch.empty_like(V)
	fn = lib.dia_stencil_f32 if V.dtype == torch.float32 else lib.dia_stencil_f64
	err = fn(bands.data_ptr(), offsets.data_ptr(), bands.shape[0], V.data_ptr(), out.data_ptr(), n, k, stream(V.device))
	raise_on(lib, err, "dia_stencil")
	LAUNCHES["dia_stencil"] += 1
	return out
