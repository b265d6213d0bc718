"""Autograd through the kernel wrappers: each operator apply as a ``torch.autograd.Function``.

The JAX package differentiates its operator applies with XLA's autodiff of the
stencil and gather paths (``jax.vjp`` of ``matmat``, ``primate_tpu/autodiff.py:102-107``);
its Pallas kernels have no backward. Here every apply that launches a hand-written
kernel is a Function:

* forward: the kernel wrapper as it is (the kernel on a CUDA tensor, the plain
  version on a CPU tensor), run under no grad;
* input gradient: the adjoint apply ``Aᴴ G`` by the same kernel, on the adjoint
  bands ``band'_{−d}[i] = conj(band_d[i − d])`` (DIA) or on the tiles conjugate-transposed
  and sorted by block column (BSR);
* parameter gradient, by PyTorch reductions: ``grad_band_d[r] = Σ_b G[b, r]·conj(x[b, r + off_d])``
  (exactly 0 where ``r + off_d`` leaves ``[0, n)``, as JAX's zero-padded stencil gives),
  ``grad_tile_t = G[rowblock_t] · V[colblock_t]ᴴ`` (one batched product over the
  stored tiles, TF32 off).

The CSR apply (cuSPARSE through ``torch.sparse``) gets the same kind of Function,
so no gradient depends on ``torch.sparse``'s own autograd, which differs between
devices and versions: ``grad_data[j] = Σ_b G[row_j, b]·conj(V[col_j, b])`` and the input
gradient through the conjugate-transposed matrix, whose structure is built once per operator.

Complex (Hermitian) operators follow PyTorch's convention: for a real loss ``L`` the
gradient handed back is ``∂L/∂conj(·)``, the conjugate of ``jax.grad``'s. The conjugates
above are no-ops on real tensors. Every tensor that reaches a kernel is a written-out one
(``G`` arrives through autograd's ``conj`` nodes as a lazy view; the wrappers resolve it).
The parameter reductions are chunked so their temporaries stay bounded at any n.
"""

import torch

from ..linalg import full_f32_matmul
from ._common import acc_dtype, resolved
from .bsr import block_rowids, bsr_spmm
from .dia import dia_stencil, dia_stencil_t

__all__ = ["dia_stencil_t_ad", "dia_stencil_ad", "bsr_spmm_ad", "csr_spmm_ad", "dia_adjoint", "bsr_adjoint"]

# Elements of a parameter reduction's product temporary at once (64 MB in float32).
_CHUNK_ELEMS = 1 << 24


def dia_adjoint(bands: torch.Tensor, offsets: tuple):
	"""Row-aligned bands and offsets of ``Aᴴ`` (``Aᵀ`` of a real ``A``): ``band'_{−d}[i] = conj(band_d[i − d])``,
	0 outside ``[0, n)``. One written-out copy of the bands."""
	n = bands.shape[1]
	src = bands.conj()
	adj = torch.zeros_like(bands)
	for d, off in enumerate(offsets):
		if abs(off) >= n:
			continue
		if off >= 0:
			adj[d, off:] = src[d, : n - off]
		else:
			adj[d, : n + off] = src[d, -off:]
	return adj, tuple(-o for o in offsets)


def _band_grad(G: torch.Tensor, X: torch.Tensor, offsets: tuple, dtype: torch.dtype, probe_major: bool) -> torch.Tensor:
	"""``out[d, r] = Σ_b G[r]·conj(X[r + off_d])`` over the probe axis, 0 where ``r + off_d`` leaves ``[0, n)``."""
	n = G.shape[1] if probe_major else G.shape[0]
	width = G.shape[0] if probe_major else G.shape[1]
	acc = acc_dtype(dtype)
	X = X.conj()
	out = torch.zeros((len(offsets), n), dtype=acc, device=G.device)
	step = max(1, _CHUNK_ELEMS // max(1, width))
	for d, off in enumerate(offsets):
		lo, hi = max(0, -off), min(n, n - off)
		for r0 in range(lo, hi, step):
			r1 = min(hi, r0 + step)
			if probe_major:
				prod = G[:, r0:r1].to(acc) * X[:, r0 + off : r1 + off].to(acc)
				out[d, r0:r1] = torch.sum(prod, dim=0)
			else:
				prod = G[r0:r1].to(acc) * X[r0 + off : r1 + off].to(acc)
				out[d, r0:r1] = torch.sum(prod, dim=1)
	return out.to(dtype)


class _DIAStencil(torch.autograd.Function):
	"""The probe-major (``x (nv, n)``, :func:`dia_stencil_t`) or node-major (``x (n, k)``,
	:func:`dia_stencil`) DIA stencil, differentiable in ``bands`` and ``x``."""

	@staticmethod
	def forward(ctx, bands, x, offsets_t, offsets, probe_major):
		ctx.offsets, ctx.probe_major = offsets, probe_major
		ctx.save_for_backward(bands, x, offsets_t)
		return (dia_stencil_t if probe_major else dia_stencil)(bands, offsets_t, x)

	@staticmethod
	def backward(ctx, G):
		bands, x, offsets_t = ctx.saved_tensors
		G = resolved(G).contiguous()
		grad_bands = grad_x = None
		if ctx.needs_input_grad[1]:
			adj, _ = dia_adjoint(bands, ctx.offsets)
			grad_x = (dia_stencil_t if ctx.probe_major else dia_stencil)(adj, -offsets_t, G)
		if ctx.needs_input_grad[0]:
			grad_bands = _band_grad(G, x, ctx.offsets, bands.dtype, ctx.probe_major)
		return grad_bands, grad_x, None, None, None


def dia_stencil_t_ad(bands: torch.Tensor, x: torch.Tensor, offsets_t: torch.Tensor, offsets: tuple) -> torch.Tensor:
	"""Differentiable :func:`~primate_tpu_torch.ops.dia.dia_stencil_t`; ``offsets`` the host copy of ``offsets_t``."""
	return _DIAStencil.apply(bands, x, offsets_t, offsets, True)


def dia_stencil_ad(bands: torch.Tensor, V: torch.Tensor, offsets_t: torch.Tensor, offsets: tuple) -> torch.Tensor:
	"""Differentiable :func:`~primate_tpu_torch.ops.dia.dia_stencil`; ``offsets`` the host copy of ``offsets_t``."""
	return _DIAStencil.apply(bands, V, offsets_t, offsets, False)


def bsr_adjoint(blocks: torch.Tensor, indptr: torch.Tensor, indices: torch.Tensor, m: int):
	"""Tiles, block-row pointers and block-column ids of ``Aᴴ`` (``Aᵀ`` of a real ``A``) for a BSR ``A``
	with ``m`` columns: each tile conjugate-transposed, the tiles sorted by their block column
	(stable, so each block row of ``Aᴴ`` keeps its tiles in order). The tiles are written out."""
	bn = blocks.shape[2]
	n_bcol = -(-m // bn)
	perm = torch.argsort(indices, stable=True)
	counts = torch.bincount(indices, minlength=n_bcol)
	indptr_t = torch.cat([torch.zeros(1, dtype=torch.int64, device=indices.device), torch.cumsum(counts, 0)])
	tiles = blocks[perm].transpose(1, 2)
	out = torch.empty(tiles.shape, dtype=blocks.dtype, device=blocks.device)
	out.copy_(tiles.conj())
	return out, indptr_t, block_rowids(indptr)[perm].contiguous()


def _padded_blocks(X: torch.Tensor, rows: int, b: int, acc: torch.dtype) -> torch.Tensor:
	"""``X (m, k)`` zero-padded to ``rows · b`` rows, as ``(rows, b, k)`` in ``acc``."""
	out = torch.zeros((rows * b, X.shape[1]), dtype=acc, device=X.device)
	out[: X.shape[0]] = X
	return out.view(rows, b, X.shape[1])


class _BSRSpMM(torch.autograd.Function):
	"""``out (n_out, k) = bsr_spmm(blocks, indptr, indices, V, n_out)``, differentiable in ``blocks`` and ``V``."""

	@staticmethod
	def forward(ctx, blocks, V, indptr, indices, n_out):
		ctx.n_out = n_out
		ctx.save_for_backward(blocks, V, indptr, indices)
		return bsr_spmm(blocks, indptr, indices, V, n_out)

	@staticmethod
	def backward(ctx, G):
		blocks, V, indptr, indices = ctx.saved_tensors
		nnzb, bm, bn = blocks.shape
		n_brow, (m, k) = indptr.shape[0] - 1, V.shape
		G = resolved(G).contiguous()
		grad_blocks = grad_V = None
		if ctx.needs_input_grad[1]:
			blocks_t, indptr_t, indices_t = bsr_adjoint(blocks, indptr, indices, m)
			if n_brow > -(-G.shape[0] // bm):  # block rows past n_out: their rows of G count as zero
				G_in = torch.zeros((n_brow * bm, k), dtype=G.dtype, device=G.device)
				G_in[: G.shape[0]] = G
			else:
				G_in = G
			grad_V = bsr_spmm(blocks_t, indptr_t, indices_t, G_in, m)
		if ctx.needs_input_grad[0]:
			acc = acc_dtype(blocks.dtype)
			Gb = _padded_blocks(G, n_brow, bm, acc)
			Vb = _padded_blocks(V, -(-m // bn), bn, acc)
			rowids = block_rowids(indptr)
			grad_blocks = torch.empty((nnzb, bm, bn), dtype=acc, device=blocks.device)
			step = max(1, _CHUNK_ELEMS // max(1, (bm + bn) * k))
			with full_f32_matmul():
				for z0 in range(0, nnzb, step):
					z1 = min(nnzb, z0 + step)
					torch.bmm(Gb[rowids[z0:z1]], Vb[indices[z0:z1]].mH, out=grad_blocks[z0:z1])
			grad_blocks = grad_blocks.to(blocks.dtype)
		return grad_blocks, grad_V, None, None, None


def bsr_spmm_ad(blocks: torch.Tensor, V: torch.Tensor, indptr: torch.Tensor, indices: torch.Tensor, n_out: int) -> torch.Tensor:
	"""Differentiable :func:`~primate_tpu_torch.ops.bsr.bsr_spmm`."""
	return _BSRSpMM.apply(blocks, V, indptr, indices, n_out)


class _CSRSpMM(torch.autograd.Function):
	"""``out (n, k) = op.csr @ V`` for a :class:`~primate_tpu_torch.operators.sparse.CSROperator`,
	differentiable in its ``data`` and ``V``."""

	@staticmethod
	def forward(ctx, data, V, op):
		ctx.op = op
		V = resolved(V)
		ctx.save_for_backward(data, V)
		return op.csr @ V

	@staticmethod
	def backward(ctx, G):
		data, V = ctx.saved_tensors
		op = ctx.op
		G = resolved(G).contiguous()
		grad_data = grad_V = None
		if ctx.needs_input_grad[1]:
			grad_V = op.adjoint_csr() @ G
		if ctx.needs_input_grad[0]:
			acc = acc_dtype(data.dtype)
			rows, cols = op.rowids, op.indices.long()
			grad_data = torch.empty(data.shape[0], dtype=acc, device=data.device)
			step = max(1, _CHUNK_ELEMS // max(1, G.shape[1]))
			for j0 in range(0, data.shape[0], step):
				j1 = min(data.shape[0], j0 + step)
				grad_data[j0:j1] = torch.sum(G[rows[j0:j1]].to(acc) * V[cols[j0:j1]].conj().to(acc), dim=1)
			grad_data = grad_data.to(data.dtype)
		return grad_data, grad_V, None


def csr_spmm_ad(data: torch.Tensor, V: torch.Tensor, op) -> torch.Tensor:
	"""Differentiable ``op.csr @ V`` of a CSR operator whose values are ``data``."""
	return _CSRSpMM.apply(data, V, op)
