"""What the kernel wrappers share: launch counts, argument checks, launch-error handling."""

import torch

__all__ = ["LAUNCHES", "BF16_LAUNCHES", "LAYOUT_COPIES", "SCALAR_LAUNCHES", "L2_LAUNCHES", "reset_launches", "resolved"]

# Kernel launches per wrapper since the last `reset_launches()`. Each wrapper adds
# one where it launches its kernel and nowhere else; its plain version counts nothing.
# The round pair (``lanczos_dia_round``, two kernels that finish a bfloat16 step) counts one a pair, and
# the CGS window (``cgs_window``, the chain that ends a re-orthogonalised step) one a step.
LAUNCHES = {
	"dia_stencil_t": 0, "lanczos_dia_step": 0, "lanczos_dia_residual": 0, "lanczos_dia_advance": 0, "lanczos_dia_round": 0,
	"dia_stencil": 0, "bsr_spmm": 0, "cgs_window": 0,
}
# The launches of LAUNCHES that ran a kernel's bfloat16 instantiation.
BF16_LAUNCHES = {"dia_stencil_t": 0, "lanczos_dia_step": 0, "lanczos_dia_round": 0, "dia_stencil": 0, "bsr_spmm": 0}
# Copies an operator made to hand a kernel or library call the layout it reads
# (a probe-major block made node-major for the BSR kernel), or to hand back the
# layout its caller reads (the CSR product of a probe-major block), per apply.
LAYOUT_COPIES = {"bsr_spmm": 0, "csr_spmm": 0}
# Launches that took a kernel's scalar path: a length or a pointer that does not
# allow its 16-byte loads and stores (see `vector_ok`).
SCALAR_LAUNCHES = {
	"dia_stencil_t": 0, "lanczos_dia_step": 0, "lanczos_dia_residual": 0, "lanczos_dia_advance": 0, "lanczos_dia_round": 0,
	"dia_stencil": 0, "bsr_spmm": 0, "cgs_window": 0,
}
# Launches of ``bsr_spmm`` that took its L2 path (complex128, 8×8 tiles, V small enough for the L2).
L2_LAUNCHES = {"bsr_spmm": 0}
# The C entry point's suffix of each dtype a kernel takes.
SUFFIX = {
	torch.float32: "f32", torch.float64: "f64", torch.bfloat16: "bf16", torch.complex64: "c64", torch.complex128: "c128",
}


def reset_launches() -> None:
	"""Zero :data:`LAUNCHES`, :data:`BF16_LAUNCHES`, :data:`LAYOUT_COPIES`, :data:`SCALAR_LAUNCHES` and :data:`L2_LAUNCHES`."""
	for counts in (LAUNCHES, BF16_LAUNCHES, LAYOUT_COPIES, SCALAR_LAUNCHES, L2_LAUNCHES):
		for k in counts:
			counts[k] = 0


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
	return torch.promote_types(dtype, torch.float32)


def resolved(t: torch.Tensor) -> torch.Tensor:
	"""``t`` with a lazy conjugate or negation written out (``x.conj()`` and ``x.conj().imag`` are
	views that share ``x``'s memory and carry a flag): a kernel reads the bytes, not the flag. ``t``
	itself when it carries neither."""
	return t.resolve_conj().resolve_neg()


def check_cuda(
	name: str, dtype: torch.dtype, device: torch.device, int_keys=(), complex_ok: bool = False, bf16_ok: bool = False,
	acc_keys=(), bf16_only: bool = False, **tensors,
) -> None:
	"""Raise on anything the kernels do not take: float32/float64 contiguous tensors (also
	bfloat16 where ``bf16_ok``: the two DIA stencils, pass A and the BSR SpMM; bfloat16 alone where
	``bf16_only``: the round pair; complex64/complex128 where ``complex_ok``: the two stencils, the
	BSR SpMM and the two step passes) on one CUDA device, int64 index tensors (``int_keys``), and
	tensors in the real accumulation dtype (``acc_keys``: float32 for bfloat16 and complex64, float64
	for complex128: a step's state, β and outputs). float16 raises ``TypeError``, as the JAX
	package's operators refuse it. A lazy conjugate or negative view raises ``ValueError``: the
	kernel would read its memory unconjugated (the stencil and SpMM wrappers hand :func:`resolved`
	tensors)."""
	if device.type != "cuda":
		raise ValueError(f"{name}: tensors must lie on the CPU (plain version) or on a CUDA device; got {device}")
	if dtype.is_complex and not complex_ok:
		raise NotImplementedError(f"{name}: complex operators have no CUDA kernel of this kind")
	if bf16_only:
		takes = (torch.bfloat16,)
	else:
		takes = (torch.float32, torch.float64) + ((torch.bfloat16,) if bf16_ok else ()) + ((torch.complex64, torch.complex128) if complex_ok else ())
	if dtype not in takes:
		raise TypeError(f"{name}: the CUDA kernel takes {', '.join(str(t).replace('torch.', '') for t in takes)}; got {dtype}")
	for key, t in tensors.items():
		if t.is_conj() or t.is_neg():
			raise ValueError(f"{name}: {key} is a lazy conjugate or negative view; pass resolved(t)")
		want = torch.int64 if key in int_keys else acc_dtype(dtype).to_real() if key in acc_keys else dtype
		if t.device != device:
			raise ValueError(f"{name}: {key} is on {t.device}, expected {device}")
		if t.dtype != want:
			raise TypeError(f"{name}: {key} has dtype {t.dtype}, expected {want}")
		if not t.is_contiguous():
			raise ValueError(f"{name}: {key} must be contiguous")


def count_launch(name: str, dtype: torch.dtype, vec: bool) -> None:
	"""One launch of ``name``'s kernel: in :data:`LAUNCHES`, and in :data:`BF16_LAUNCHES` or
	:data:`SCALAR_LAUNCHES` where it ran the bfloat16 instantiation or the scalar path."""
	LAUNCHES[name] += 1
	SCALAR_LAUNCHES[name] += not vec
	if dtype == torch.bfloat16:
		BF16_LAUNCHES[name] += 1


def raise_on(lib, err: int, name: str) -> None:
	if err != 0:
		raise RuntimeError(f"{name}: CUDA launch failed: {lib.primate_cuda_error_string(err).decode()} ({err})")


def stream(device: torch.device) -> int:
	return torch.cuda.current_stream(device).cuda_stream


def vector_ok(length: int, elem_size: int, *tensors, lead: int = 0) -> bool:
	"""Whether a kernel may move rows of ``length`` elements in 16-byte vectors: the length
	(a carry's row stride ``ld``) and the columns before its own rows (``lead``, a carry's ``lo``)
	are whole numbers of vectors and every tensor starts 16-byte aligned."""
	vl = 16 // elem_size
	return length % vl == 0 and lead % vl == 0 and all(t.data_ptr() % 16 == 0 for t in tensors)
