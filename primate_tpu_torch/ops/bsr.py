"""Block-sparse-row SpMM kernel: wrapper, plain PyTorch version, launch count.

:func:`bsr_spmm` runs the hand-written CUDA kernel of ``csrc/bsr_spmm.cu``, which
replaces the Pallas TPU kernel ``bsr_matmat_pallas`` (``primate_tpu/ops/spmm_pallas.py``):
``out[r·bm:(r+1)·bm, :] = Σ tile @ V[col·bn:(col+1)·bn, :]`` over the stored
tiles of each block row. One CUDA block walks ``indptr`` for its block row and
writes each output tile once, so the TPU kernel's scalar-prefetch cap of 16,384
tiles, its 128-lane probe padding and its fallback have no counterpart.

The kernel reads ``V`` node-major: ``(m, k)`` contiguous, probes along the fast
axis. The wrapper does not copy: a caller with a probe-major block makes it
contiguous itself (``BSROperator.matmat`` does, and counts it in
:data:`LAYOUT_COPIES`). On CPU tensors the wrapper runs :func:`bsr_spmm_ref`; on a
CUDA tensor it launches the kernel or raises, and counts each launch in
``LAUNCHES["bsr_spmm"]``.
"""

import torch

from ._common import LAUNCHES, LAYOUT_COPIES, acc_dtype, check_cuda, raise_on, reset_launches, stream

__all__ = ["LAUNCHES", "LAYOUT_COPIES", "reset_launches", "bsr_spmm", "bsr_spmm_ref", "block_rowids"]

# Elements of the gathered (tiles, bn, k) block the plain version holds at once.
_REF_CHUNK_ELEMS = 1 << 27


def block_rowids(indptr: torch.Tensor) -> torch.Tensor:
	"""The block-row id of every stored tile, from ``indptr (n_brow + 1,)``."""
	counts = indptr[1:] - indptr[:-1]
	return torch.repeat_interleave(torch.arange(counts.shape[0], device=indptr.device), counts)


def bsr_spmm_ref(
	blocks: torch.Tensor, indptr: torch.Tensor, indices: torch.Tensor, V: torch.Tensor, n_out: int
) -> torch.Tensor:
	"""Plain version of :func:`bsr_spmm`: gather the tiles' V rows, one batched tile
	product, ``index_add_`` over block rows (the JAX ``_matmat_jnp`` segment-sum
	path, ``primate_tpu/operators/sparse.py:627-631``). Accumulates in
	``promote_types(blocks, V, float32)``, returns ``V.dtype``; chunked over tiles
	so the gathered block stays bounded."""
	nnzb, bm, bn = blocks.shape
	m, k = V.shape
	n_brow = indptr.shape[0] - 1
	acc = acc_dtype(torch.promote_types(blocks.dtype, V.dtype))
	n_bcol = -(-m // bn)
	Vp = torch.zeros((n_bcol * bn, k), dtype=acc, device=V.device)
	Vp[:m] = V
	Vb = Vp.reshape(n_bcol, bn, k)
	rowids = block_rowids(indptr)
	out = torch.zeros((n_brow, bm, k), dtype=acc, device=V.device)
	step = max(1, _REF_CHUNK_ELEMS // max(1, bn * k))
	for z0 in range(0, nnzb, step):
		z1 = min(nnzb, z0 + step)
		prod = torch.bmm(blocks[z0:z1].to(acc), Vb[indices[z0:z1]])
		out.index_add_(0, rowids[z0:z1], prod)
	return out.reshape(n_brow * bm, k)[:n_out].to(V.dtype)


def bsr_spmm(blocks: torch.Tensor, indptr: torch.Tensor, indices: torch.Tensor, V: torch.Tensor, n_out: int) -> torch.Tensor:
	"""BSR SpMM ``out (n_out, k) = A V``.

	``blocks (nnzb, bm, bn)`` row-sorted tiles, ``indptr (n_brow + 1,)`` and
	``indices (nnzb,)`` int64 block-row pointers and block-column ids, ``V (m, k)``
	contiguous, whose rows past ``m`` in the last block column count as zero
	(every block-column id is below ``ceil(m / bn)``), and ``n_out ≤ n_brow·bm``.
	Any ``bm``, ``bn`` and ``k``.
	"""
	if blocks.ndim != 3 or indptr.ndim != 1 or indices.ndim != 1 or V.ndim != 2:
		raise ValueError("bsr_spmm: expected blocks (nnzb, bm, bn), indptr (n_brow + 1,), indices (nnzb,), V (m, k)")
	nnzb, bm, bn = blocks.shape
	n_brow = indptr.shape[0] - 1
	if indices.shape[0] != nnzb or not 0 <= n_out <= n_brow * bm:
		raise ValueError(f"bsr_spmm: {indices.shape[0]} indices for {nnzb} tiles, n_out={n_out} for {n_brow} block rows of {bm}")
	if V.device.type == "cpu":
		return bsr_spmm_ref(blocks, indptr, indices, V, n_out)
	check_cuda("bsr_spmm", V.dtype, V.device, ("indptr", "indices"), blocks=blocks, indptr=indptr, indices=indices, V=V)
	from ._build import load_library

	lib = load_library("bsr_spmm")
	m, k = V.shape
	out = torch.empty((n_out, k), dtype=V.dtype, device=V.device)
	fn = lib.bsr_spmm_f32 if V.dtype == torch.float32 else lib.bsr_spmm_f64
	err = fn(
		blocks.data_ptr(), indptr.data_ptr(), indices.data_ptr(), V.data_ptr(), out.data_ptr(),
		n_brow, bm, bn, m, k, n_out, stream(V.device),
	)
	raise_on(lib, err, "bsr_spmm")
	LAUNCHES["bsr_spmm"] += 1
	return out
