"""Block-sparse-row SpMM kernel: wrapper, plain PyTorch version, launch count.

:func:`bsr_spmm` runs the hand-written CUDA kernel of ``csrc/bsr_spmm.cu``, which
replaces the Pallas TPU kernel ``bsr_matmat_pallas`` (``primate_tpu/ops/spmm_pallas.py``):
``out[r·bm:(r+1)·bm, :] = Σ tile @ V[col·bn:(col+1)·bn, :]`` over the stored
tiles of each block row. A persistent grid of lane teams walks ranges of block
rows cut by tile count, keeps several tiles' V gathers in flight through a
``cp.async`` ring in shared memory and writes each output tile once, so the TPU
kernel's scalar-prefetch cap of 16,384 tiles, its 128-lane probe padding and its
fallback have no counterpart. It moves V and the output in 16-byte vectors when
``k`` is a whole number of them and ``V``, the output and the tiles are 16-byte
aligned, element by element otherwise; the launches that took the scalar path
are counted in ``SCALAR_LAUNCHES["bsr_spmm"]``. A complex128 product with 8×8 tiles whose ``V`` fits
in the card's L2 takes a path of its own (float64 MMAs on the tensor cores, ``V`` read straight
through L2; ``csrc/bsr_spmm.cu``), counted in ``L2_LAUNCHES["bsr_spmm"]``: its sum order is the
MMA's, so it agrees with the plain version within complex128's rounding, not bit for bit.

The kernel reads ``V`` node-major: ``(m, k)`` contiguous, probes along the fast
axis. The wrapper does not copy: a caller with a probe-major block makes it
contiguous itself (``BSROperator.matmat`` does, and counts it in
:data:`LAYOUT_COPIES`). On CPU tensors the wrapper runs :func:`bsr_spmm_ref`; on a
CUDA tensor it launches the kernel or raises, and counts each launch in
``LAUNCHES["bsr_spmm"]``. A lazy conjugate or negation of the tiles or of ``V`` is written out
before the launch (``V.conj()`` shares ``V``'s memory).
"""

import torch

from ._common import (
	L2_LAUNCHES, LAUNCHES, LAYOUT_COPIES, SUFFIX, acc_dtype, check_cuda, count_launch, raise_on, reset_launches, resolved, stream,
	vector_ok,
)

__all__ = ["LAUNCHES", "LAYOUT_COPIES", "L2_LAUNCHES", "reset_launches", "bsr_spmm", "bsr_spmm_ref", "block_rowids"]

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
	Any ``bm``, ``bn`` and ``k``; float32, float64, bfloat16 (summed in float32, rounded once),
	complex64 or complex128 (tiles and ``V`` of one dtype).
	"""
	if blocks.ndim != 3 or indptr.ndim != 1 or indices.ndim != 1 or V.ndim != 2:
		raise ValueError("bsr_spmm: expected blocks (nnzb, bm, bn), indptr (n_brow + 1,), indices (nnzb,), V (m, k)")
	nnzb, bm, bn = blocks.shape
	n_brow = indptr.shape[0] - 1
	if indices.shape[0] != nnzb or not 0 <= n_out <= n_brow * bm:
		raise ValueError(f"bsr_spmm: {indices.shape[0]} indices for {nnzb} tiles, n_out={n_out} for {n_brow} block rows of {bm}")
	if V.device.type == "cpu":
		return bsr_spmm_ref(blocks, indptr, indices, V, n_out)
	blocks, V = resolved(blocks), resolved(V)
	check_cuda(
		"bsr_spmm", V.dtype, V.device, ("indptr", "indices"), complex_ok=True, bf16_ok=True, blocks=blocks, indptr=indptr,
		indices=indices, V=V,
	)
	from ._build import load_library

	lib = load_library("bsr_spmm")
	m, k = V.shape
	out = torch.empty((n_out, k), dtype=V.dtype, device=V.device)
	fn = getattr(lib, f"bsr_spmm_{SUFFIX[V.dtype]}")
	vec = vector_ok(k, V.element_size(), blocks, V, out)
	err = fn(
		blocks.data_ptr(), indptr.data_ptr(), indices.data_ptr(), V.data_ptr(), out.data_ptr(),
		n_brow, bm, bn, m, k, n_out, int(vec), stream(V.device),
	)
	raise_on(lib, err, "bsr_spmm")
	count_launch("bsr_spmm", V.dtype, vec)
	L2_LAUNCHES["bsr_spmm"] += V.dtype == torch.complex128 and bool(lib.bsr_spmm_l2_path(bm, bn, m, k))
	return out
