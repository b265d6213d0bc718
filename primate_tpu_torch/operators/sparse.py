"""Sparse operators on torch tensors: block-sparse-row (BSR) and banded (DIA).

Counterparts of ``BSROperator`` and ``DIAOperator`` in
``primate_tpu/operators/sparse.py:449-911``. Their applies run the CUDA kernels
of :mod:`primate_tpu_torch.ops` on the card and the kernels' plain versions on
the CPU.

DIA: row-aligned convention ``bands[d, i] = A[i, i + offsets[d]]``, so
``(A x)[i] = Σ_d bands[d, i]·x[i + offsets[d]]``. The TPU's halo-padded carry
(``phys_spec``/``matmat_t_phys``) has no counterpart: the kernels bounds-check
the edges instead.

BSR: scipy's layout, tiles ``(nnzb, bm, bn)`` with ``indptr``/``indices`` over
block rows. The JAX package's block-ELL planes (``bell_blocks``) are an XLA
gather layout; the kernel walks ``indptr`` itself and needs none.
"""

import warnings
from typing import Optional, Tuple

import numpy as np
import torch

from ..ops._common import LAYOUT_COPIES
from ..ops.bsr import block_rowids, bsr_spmm
from ..ops.dia import dia_stencil, dia_stencil_t, lanczos_dia_step
from .base import LinearOperator

__all__ = ["BSROperator", "DIAOperator"]


class BSROperator(LinearOperator):
	"""Block-sparse-row operator: nonzeros stored as dense ``(bm × bn)`` tiles.

	``shape`` is the logical shape; the tile grid (:attr:`pshape`) may overhang
	it by zero rows and columns. ``matmat`` runs the BSR SpMM kernel on a
	node-major ``(n, k)`` block: a block that is not contiguous (a probe block
	from :func:`~primate_tpu_torch.random.sample_isotropic` is probe-major in
	memory) is copied to that layout once per apply, and the copy is counted in
	``ops.LAYOUT_COPIES["bsr_spmm"]``.
	"""

	def __init__(self, blocks: torch.Tensor, indices: torch.Tensor, indptr: torch.Tensor, shape: Tuple[int, int]):
		self.blocks = blocks.contiguous()  # (nnzb, bm, bn)
		self.dtype = self.blocks.dtype
		self.device = self.blocks.device
		self.indices = torch.as_tensor(indices, dtype=torch.int64, device=self.device).contiguous()
		self.indptr = torch.as_tensor(indptr, dtype=torch.int64, device=self.device).contiguous()
		self.shape = tuple(int(s) for s in shape)
		if self.blocks.ndim != 3 or self.indices.shape[0] != self.blocks.shape[0]:
			raise ValueError(f"blocks {tuple(self.blocks.shape)} do not match {self.indices.shape[0]} block-column ids")
		if (self.indptr.shape[0] - 1) * self.blocks.shape[1] < self.shape[0]:
			raise ValueError(f"{self.indptr.shape[0] - 1} block rows of {self.blocks.shape[1]} do not cover {self.shape[0]} rows")
		self.rowids = block_rowids(self.indptr)

	@classmethod
	def from_numpy(cls, blocks, indices, indptr, shape, *, dtype=None, device="cpu") -> "BSROperator":
		"""From numpy tiles ``(nnzb, bm, bn)``, block-column ids and block-row pointers."""
		return cls(torch.tensor(np.asarray(blocks), dtype=dtype, device=device), np.asarray(indices), np.asarray(indptr), shape)

	@classmethod
	def from_scipy(cls, A, blocksize: Optional[Tuple[int, int]] = None, dtype=None, device="cpu") -> "BSROperator":
		"""From a scipy sparse (or dense) matrix through scipy's ``tobsr``
		(``primate_tpu/operators/sparse.py:528-556``, its scipy path): the matrix is
		zero-padded to whole tiles. An empty block row stores no tile: the kernel
		writes its zeros (the JAX package pads it with a zero tile for its Pallas kernel)."""
		import scipy.sparse as sps

		if not sps.issparse(A):
			A = sps.csr_matrix(np.asarray(A))
		shape = A.shape
		nnz_logical = int(A.nnz)  # before tobsr: a BSR matrix's nnz counts stored tile entries
		if blocksize is not None:
			bm, bn = blocksize
			padded = (-(-shape[0] // bm) * bm, -(-shape[1] // bn) * bn)
			if padded != shape:
				A = sps.csr_matrix(A)
				A.resize(padded)
		A = A.tobsr(blocksize=blocksize) if blocksize is not None else A.tobsr()
		op = cls.from_numpy(A.data, A.indices, A.indptr, shape, dtype=dtype, device=device)
		op._warn_fill_in(nnz_logical)
		return op

	@classmethod
	def from_dense(cls, A, blocksize: Tuple[int, int] = (8, 128), dtype=None, device="cpu") -> "BSROperator":
		return cls.from_scipy(np.asarray(A), blocksize=blocksize, dtype=dtype, device=device)

	def _warn_fill_in(self, nnz_logical: int) -> None:
		"""Warn when the tiles store mostly zeros: more than 8x the logical nonzeros."""
		stored = self.nnz
		if nnz_logical > 0 and stored > 8 * nnz_logical:
			warnings.warn(
				f"BSROperator tiles are {stored / nnz_logical:.0f}x the logical nnz "
				f"({stored} stored vs {nnz_logical}); the sparsity pattern is not "
				f"block-structured at blocksize {self.blocksize} — a DIA operator "
				"(for banded matrices) or another sparse format will be faster.",
				stacklevel=3,
			)

	@property
	def blocksize(self) -> Tuple[int, int]:
		return tuple(self.blocks.shape[1:])

	@property
	def pshape(self) -> Tuple[int, int]:
		"""Padded shape: the tile grid rounded up to whole ``(bm × bn)`` tiles."""
		bm, bn = self.blocksize
		return (-(-self.shape[0] // bm) * bm, -(-self.shape[1] // bn) * bn)

	@property
	def nnz(self) -> int:
		return int(np.prod(self.blocks.shape))

	def _matmat(self, V: torch.Tensor) -> torch.Tensor:
		V = torch.as_tensor(V, dtype=self.dtype, device=self.device)
		if not V.is_contiguous():
			V = V.contiguous()
			LAYOUT_COPIES["bsr_spmm"] += 1
		return bsr_spmm(self.blocks, self.indptr, self.indices, V, self.shape[0])

	def rmatmat(self, V: torch.Tensor) -> torch.Tensor:
		"""Adjoint block apply ``A† V`` (plain PyTorch: gather, tile product, ``index_add_``)."""
		bm, bn = self.blocksize
		V = torch.as_tensor(V, device=self.device)
		single = V.ndim == 1
		V = V[:, None] if single else V
		k = V.shape[1]
		np_r, np_c = self.pshape
		acc = torch.promote_types(self.dtype, torch.float32)
		Vp = torch.zeros((np_r, k), dtype=acc, device=self.device)
		Vp[: V.shape[0]] = V
		prod = torch.bmm(self.blocks.conj().transpose(1, 2).to(acc), Vp.reshape(-1, bm, k)[self.rowids])
		out = torch.zeros((np_c // bn, bn, k), dtype=acc, device=self.device).index_add_(0, self.indices, prod)
		out = out.reshape(np_c, k)[: self.shape[1]].to(self.dtype)
		return out[:, 0] if single else out

	def rmatvec(self, v: torch.Tensor) -> torch.Tensor:
		return self.rmatmat(v)

	def todense(self) -> torch.Tensor:
		bm, bn = self.blocksize
		np_r, np_c = self.pshape
		out = torch.zeros((np_r // bm, np_c // bn, bm, bn), dtype=self.dtype, device=self.device)
		out.index_put_((self.rowids, self.indices), self.blocks, accumulate=True)
		return out.transpose(1, 2).reshape(np_r, np_c)[: self.shape[0], : self.shape[1]]



class DIAOperator(LinearOperator):
	"""Diagonal/banded operator: one length-n band per nonzero diagonal."""

	def __init__(self, bands: torch.Tensor, offsets: Tuple[int, ...], shape: Tuple[int, int]):
		self.bands = bands.contiguous()  # (n_diags, n)
		self.offsets = tuple(int(o) for o in offsets)
		self.shape = tuple(int(s) for s in shape)
		if self.bands.shape != (len(self.offsets), self.shape[0]):
			raise ValueError(f"bands {tuple(self.bands.shape)} do not match {len(self.offsets)} offsets and n={self.shape[0]}")
		self.dtype = self.bands.dtype
		self.device = self.bands.device
		# The kernels read the offsets from device memory; upload them once.
		self.offsets_t = torch.tensor(self.offsets, dtype=torch.int64, device=self.device)

	@classmethod
	def from_numpy(cls, bands, offsets, shape, *, dtype=None, device="cpu") -> "DIAOperator":
		"""From row-aligned numpy bands ``(n_diags, n)`` (e.g. ``np.asarray(jax_op.bands)``)."""
		return cls(torch.tensor(np.asarray(bands), dtype=dtype, device=device), offsets, shape)

	@classmethod
	def from_scipy(cls, A, dtype=None, device="cpu") -> "DIAOperator":
		"""From a scipy sparse matrix, through ``A.todia()`` (``primate_tpu/operators/sparse.py:731-745``)."""
		A = A.todia()
		n = A.shape[0]
		offsets = tuple(int(o) for o in A.offsets)
		# scipy stores column-aligned (data[k][j] = A[j-off, j]), and may cut the
		# columns past the last stored entry; pad to n, then shift to row-aligned
		# and zero the out-of-range tail of each band.
		data = np.zeros((len(offsets), n), A.data.dtype)
		data[:, : min(n, A.data.shape[1])] = A.data[:, :n]
		bands = np.zeros((len(offsets), n), A.data.dtype)
		for k, off in enumerate(offsets):
			src = data[k]
			if off >= 0:
				m = n - off
				bands[k, :m] = src[off : off + m]
			else:
				m = n + off
				bands[k, -off : -off + m] = src[:m]
		return cls.from_numpy(bands, offsets, A.shape, dtype=dtype, device=device)

	@property
	def nnz(self) -> int:
		return self.bands.numel()

	def matmat_t(self, Vt: torch.Tensor) -> torch.Tensor:
		"""Probe-major stencil ``out[b, i] = Σ_d band_d[i]·Vt[b, i + off_d]`` (kernel A on the card)."""
		Vt = torch.as_tensor(Vt, dtype=self.dtype, device=self.device).contiguous()
		return dia_stencil_t(self.bands, self.offsets_t, Vt)

	def _matmat(self, V: torch.Tensor) -> torch.Tensor:
		"""``A V`` on an ``(n, k)`` block, by its layout in memory, never copying a
		probe-major or node-major block:

		* probe-major (``V.T`` contiguous and ``V`` not, as a block from
		  ``sample_isotropic`` is): the probe-major stencil on ``V.T``, and the
		  result is handed back as the transpose of its ``(k, n)`` output;
		* otherwise (node-major, as a QR factor or a GEMM product is): the
		  node-major stencil on ``V`` (made contiguous if it is neither).
		"""
		V = torch.as_tensor(V, dtype=self.dtype, device=self.device)
		if V.T.is_contiguous() and not V.is_contiguous():
			return dia_stencil_t(self.bands, self.offsets_t, V.T).T
		return dia_stencil(self.bands, self.offsets_t, V.contiguous())

	def matvec(self, v: torch.Tensor) -> torch.Tensor:
		v = torch.as_tensor(v, device=self.device)
		if v.ndim != 1:
			return self._matmat(v)
		return self.matmat_t(v[None, :])[0]

	def rmatvec(self, v: torch.Tensor) -> torch.Tensor:
		# Adjoint A†: band'_{-d}[i] = conj(band_d[i - d]).
		n = self.shape[0]
		v = torch.as_tensor(v, device=self.device)
		acc = torch.promote_types(self.dtype, torch.float32)
		out = torch.zeros(n, dtype=acc, device=self.device)
		for k, off in enumerate(self.offsets):
			lo, hi = max(0, -off), min(n, n - off)
			if lo < hi:
				out[lo + off : hi + off] += self.bands[k, lo:hi].conj().to(acc) * v[lo:hi].to(acc)
		return out.to(self.dtype)

	def todense(self) -> torch.Tensor:
		n = self.shape[0]
		out = torch.zeros(self.shape, dtype=self.dtype, device=self.device)
		idx = torch.arange(n, device=self.device)
		for k, off in enumerate(self.offsets):
			valid = (idx + off >= 0) & (idx + off < n)
			out[idx[valid], idx[valid] + off] += self.bands[k][valid]
		return out

	def lanczos_step(
		self, q_cur: torch.Tensor, q_prev: torch.Tensor, beta: torch.Tensor
	) -> Tuple[torch.Tensor, torch.Tensor]:
		"""Fused step ``v = A·q_cur − β·q_prev``, ``α = Σ v·q_cur`` (kernel B on the card)."""
		return lanczos_dia_step(self.bands, self.offsets_t, q_cur, q_prev, beta)
