"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

:func:`dia_matmat` and :func:`bsr_matmat` are the counterparts of ``primate_tpu.ops``'s two
SpMMs: ``op @ V`` for a DIA or BSR operator by its kernels (on a CPU tensor their plain
versions), with none of the TPU's rules (``k`` a multiple of 128, the prefetch cap)."""

import torch

__all__ = ["bsr_matmat", "dia_matmat"]


def _apply(op, V, kind: str, attr: str):
	if not hasattr(op, attr):
		raise TypeError(f"{kind}_matmat: expected a {kind.upper()}Operator, got {type(op).__name__}")
	V = torch.as_tensor(V, dtype=op.dtype, device=op.device)
	return op.matvec(V) if V.ndim == 1 else op.matmat(V)


def dia_matmat(op, V) -> torch.Tensor:
	"""``op @ V`` for a :class:`~primate_tpu_torch.operators.sparse.DIAOperator`, ``V (n,)`` or
	``(n, k)``, by the DIA stencil kernels (``primate_tpu/ops/dia_pallas.py:324``)."""
	return _apply(op, V, "dia", "bands")


def bsr_matmat(op, V) -> torch.Tensor:
	"""``op @ V`` for a :class:`~primate_tpu_torch.operators.sparse.BSROperator`, ``V (m,)`` or
	``(m, k)``, by the BSR SpMM kernel (``primate_tpu/ops/spmm_pallas.py:110``)."""
	return _apply(op, V, "bsr", "blocks")
