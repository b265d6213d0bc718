"""What the kernel wrappers share: launch counts, argument checks, launch-error handling."""

import torch

__all__ = ["LAUNCHES", "LAYOUT_COPIES", "reset_launches"]

# Kernel launches per wrapper since the last `reset_launches()`. Each wrapper adds
# one where it launches its kernel and nowhere else; its plain version counts nothing.
LAUNCHES = {"dia_stencil_t": 0, "lanczos_dia_step": 0, "dia_stencil": 0, "bsr_spmm": 0}
# Copies an operator made to hand a kernel the layout it reads (a probe-major
# block made node-major for the BSR kernel), per kernel.
LAYOUT_COPIES = {"bsr_spmm": 0}


def reset_launches() -> None:
	"""Zero :data:`LAUNCHES` and :data:`LAYOUT_COPIES`."""
	for counts in (LAUNCHES, LAYOUT_COPIES):
		for k in counts:
			counts[k] = 0


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
	return torch.promote_types(dtype, torch.float32)


def check_cuda(name: str, dtype: torch.dtype, device: torch.device, int_keys=(), **tensors) -> None:
	"""Raise on anything the kernels do not take: float32/float64 contiguous
	tensors on one CUDA device, and int64 index tensors (``int_keys``)."""
	if device.type != "cuda":
		raise ValueError(f"{name}: tensors must lie on the CPU (plain version) or on a CUDA device; got {device}")
	if dtype.is_complex:
		raise NotImplementedError(f"{name}: complex operators have no CUDA kernel yet")
	if dtype not in (torch.float32, torch.float64):
		raise TypeError(f"{name}: the CUDA kernel takes float32 or float64, got {dtype}")
	for key, t in tensors.items():
		want = torch.int64 if key in int_keys else dtype
		if t.device != device:
			raise ValueError(f"{name}: {key} is on {t.device}, expected {device}")
		if t.dtype != want:
			raise TypeError(f"{name}: {key} has dtype {t.dtype}, expected {want}")
		if not t.is_contiguous():
			raise ValueError(f"{name}: {key} must be contiguous")


def raise_on(lib, err: int, name: str) -> None:
	if err != 0:
		raise RuntimeError(f"{name}: CUDA launch failed: {lib.primate_cuda_error_string(err).decode()} ({err})")


def stream(device: torch.device) -> int:
	return torch.cuda.current_stream(device).cuda_stream
