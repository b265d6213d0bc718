"""Probe-major DIA stencil kernels: wrappers, plain PyTorch versions, launch counts.

Two hand-written CUDA kernels (``csrc/dia_stencil.cu``) replace the Pallas TPU
kernels of ``primate_tpu/ops/dia_pallas.py``:

* :func:`dia_stencil_t` replaces ``dia_matmat_t_pallas`` (``_dia_t_kernel``):
  ``out[b, r] = Σ_d bands[d, r] · X[b, r + off_d]``. It is ``DIAOperator.matmat_t``
  and the quadratic forms of a plain DIA operator.
* :func:`lanczos_dia_step` replaces ``dia_matmat_t_phys`` (``_dia_t_phys_kernel``),
  the stencil of the Lanczos sweep. On the TPU a ``pallas_call`` could not join
  XLA's fusion of the stencil with the β-axpy and the α reduction
  (``primate_tpu/lanczos.py:101-104``); here one kernel does all three:
  ``v = A·q_cur − β·q_prev`` and per-block partial sums of ``v·q_cur``, which the
  wrapper adds up to α (no atomics, so α is deterministic).

Both are bound by HBM bytes (a few flops per loaded element); the kernels make
one pass over the probe block and bounds-check the ragged edges, so neither the
TPU's zero-padded halo copy nor its 128-lane offset limit carries over.

Each wrapper runs its plain version (``*_ref``) only for tensors on the CPU. For
a CUDA tensor it launches the kernel or raises; it counts each launch in
:data:`LAUNCHES`.
"""

from typing import Tuple

import torch

__all__ = [
	"LAUNCHES",
	"reset_launches",
	"dia_stencil_t",
	"dia_stencil_t_ref",
	"lanczos_dia_step",
	"lanczos_dia_step_ref",
]

# Kernel launches per wrapper since the last `reset_launches()`.
LAUNCHES = {"dia_stencil_t": 0, "lanczos_dia_step": 0}


def reset_launches() -> None:
	for k in LAUNCHES:
		LAUNCHES[k] = 0


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
	return torch.promote_types(dtype, torch.float32)


def dia_stencil_t_ref(bands: torch.Tensor, offsets: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
	"""Plain version of :func:`dia_stencil_t`: ``out[b, r] = Σ_d bands[d, r]·x[b, r + off_d]``,
	accumulated in ``promote_types(dtype, float32)`` and returned in ``x.dtype``."""
	nv, n = x.shape
	acc = _acc_dtype(x.dtype)
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
	acc = _acc_dtype(q_cur.dtype)
	v = dia_stencil_t_ref(bands, offsets, q_cur).to(acc) - beta[:, None].to(acc) * q_prev.to(acc)
	alpha = torch.sum(v * q_cur.to(acc), dim=1)
	return v, alpha


def _check_cuda(name: str, dtype: torch.dtype, device: torch.device, **tensors) -> None:
	"""Raise on anything the kernels do not take: they read float32/float64
	contiguous tensors on one CUDA device."""
	if device.type != "cuda":
		raise ValueError(f"{name}: tensors must lie on the CPU (plain version) or on a CUDA device; got {device}")
	if dtype.is_complex:
		raise NotImplementedError(f"{name}: complex DIA operators have no CUDA kernel yet")
	if dtype not in (torch.float32, torch.float64):
		raise TypeError(f"{name}: the CUDA kernel takes float32 or float64, got {dtype}")
	for key, t in tensors.items():
		want = torch.int64 if key == "offsets" else dtype
		if t.device != device:
			raise ValueError(f"{name}: {key} is on {t.device}, expected {device}")
		if t.dtype != want:
			raise TypeError(f"{name}: {key} has dtype {t.dtype}, expected {want}")
		if not t.is_contiguous():
			raise ValueError(f"{name}: {key} must be contiguous")


def _raise_on(lib, err: int, name: str) -> None:
	if err != 0:
		raise RuntimeError(f"{name}: CUDA launch failed: {lib.primate_cuda_error_string(err).decode()} ({err})")


def _stream(device: torch.device) -> int:
	return torch.cuda.current_stream(device).cuda_stream


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
	_check_cuda("dia_stencil_t", x.dtype, x.device, bands=bands, offsets=offsets, x=x)
	from ._build import load_library

	lib = load_library()
	nv, n = x.shape
	out = torch.empty_like(x)
	fn = lib.dia_stencil_t_f32 if x.dtype == torch.float32 else lib.dia_stencil_t_f64
	err = fn(bands.data_ptr(), offsets.data_ptr(), bands.shape[0], x.data_ptr(), out.data_ptr(), nv, n, _stream(x.device))
	_raise_on(lib, err, "dia_stencil_t")
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
	_check_cuda(
		"lanczos_dia_step", q_cur.dtype, q_cur.device, bands=bands, offsets=offsets, q_cur=q_cur, q_prev=q_prev, beta=beta
	)
	from ._build import load_library

	lib = load_library()
	nv, n = q_cur.shape
	v = torch.empty_like(q_cur)
	partial = torch.empty((nv, lib.lanczos_dia_step_partials(n)), dtype=q_cur.dtype, device=q_cur.device)
	fn = lib.lanczos_dia_step_f32 if q_cur.dtype == torch.float32 else lib.lanczos_dia_step_f64
	err = fn(
		bands.data_ptr(), offsets.data_ptr(), bands.shape[0], q_cur.data_ptr(), q_prev.data_ptr(), beta.data_ptr(),
		v.data_ptr(), partial.data_ptr(), nv, n, _stream(q_cur.device),
	)
	_raise_on(lib, err, "lanczos_dia_step")
	LAUNCHES["lanczos_dia_step"] += 1
	return v, torch.sum(partial, dim=1)
