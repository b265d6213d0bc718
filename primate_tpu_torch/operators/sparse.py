"""Sparse operators on torch tensors: COO, CSR, block-sparse-row (BSR) and banded (DIA),
and the Gram operator of a rectangular one.

Counterparts of ``COOOperator``, ``CSROperator``, ``BSROperator``, ``DIAOperator``
and ``GramOperator`` in ``primate_tpu/operators/sparse.py:100-951``. The BSR and DIA
applies, their adjoints too, run the CUDA kernels of :mod:`primate_tpu_torch.ops` on
the card (the adjoint on the transposed tiles or the adjoint bands, built once per
operator) and plain PyTorch on the CPU. ``from_scipy`` of BSR and DIA takes
``engine="auto"|"native"|"scipy"``: the native route is the C++ loader of
:mod:`primate_tpu_torch.native`.

CSR and COO: the JAX package applies them by XLA gathers and ``segment_sum``
over ELL or sliced-ELL planes, with no Pallas kernel. Here the apply is one
library call, ``torch.sparse_csr_tensor(...) @ V`` (cuSPARSE SpMM on the card,
PyTorch's own kernel on the CPU), on the structure as scipy stores it; the ELL,
sliced-ELL and hub-tail planes are TPU layouts with no counterpart.

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
from ..ops.autograd import bsr_spmm_ad, bsr_transpose, csr_spmm_ad, dia_adjoint, dia_stencil_ad, dia_stencil_t_ad
from ..ops.bsr import block_rowids
from ..ops.dia import lanczos_dia_step, lanczos_dia_sweep_step
from .base import LinearOperator, aslinop

__all__ = ["COOOperator", "CSROperator", "BSROperator", "DIAOperator", "GramOperator"]

ENGINES = ("auto", "native", "scipy")


def _native_parts(engine: str, A, convert):
	"""``convert(native)`` on the native route: ``engine="native"``, or ``"auto"`` when the C++
	loader builds; None for scipy's route. ``"native"`` raises the loader's build error, and
	raises on complex values, which the loader does not take."""
	if engine not in ENGINES:
		raise ValueError(f"engine must be one of {ENGINES}, got {engine!r}")
	if engine == "scipy":
		return None
	from .. import native

	if engine == "native":
		native.require()
	elif not native.available():
		return None
	parts = convert(native)
	if parts is None and engine == "native":
		raise TypeError(f"the native sparse-prep engine takes real values; got {A.dtype} (use engine='scipy')")
	return parts


def _sparse_csr(indptr: torch.Tensor, indices: torch.Tensor, data: torch.Tensor, shape) -> torch.Tensor:
	"""A torch CSR tensor over the given arrays (no copy), without PyTorch's beta-state notice."""
	with warnings.catch_warnings():
		warnings.filterwarnings("ignore", message=".*[Ss]parse.*")
		return torch.sparse_csr_tensor(indptr, indices, data, size=tuple(shape), check_invariants=False)


def _index_dtype(nnz: int, shape) -> torch.dtype:
	# 32-bit indices where they fit: fewer bytes per nonzero for cuSPARSE to read.
	return torch.int32 if max(nnz, *shape) < 2**31 - 1 else torch.int64


class CSROperator(LinearOperator):
	"""Compressed-sparse-row operator (``primate_tpu/operators/sparse.py:153-447``).

	``data (nnz,)``, column ``indices`` and row pointers ``indptr`` as scipy keeps
	them (sorted, no duplicates, after :meth:`from_scipy`). Every apply is one
	library SpMM on a node-major ``(n, k)`` block. cuSPARSE takes a column-major
	(probe-major) block as it lies, but on the H100 that ran 14× slower than a
	copy to node-major and the node-major product (``PERF.md`` section 6), so a
	probe-major block is copied first, and ``matmat_t`` (the probe-major apply the
	Lanczos sweep calls) copies its result back to probe-major; each copy is
	counted in ``ops.LAYOUT_COPIES["csr_spmm"]``.
	"""

	def __init__(self, data: torch.Tensor, indices, indptr, shape: Tuple[int, int]):
		self.data = data.contiguous()
		self.dtype, self.device = self.data.dtype, self.data.device
		self.shape = tuple(int(s) for s in shape)
		idx = _index_dtype(self.data.numel(), self.shape)
		self.indices = torch.as_tensor(indices, device=self.device).to(idx).contiguous()
		self.indptr = torch.as_tensor(indptr, device=self.device).to(idx).contiguous()
		if self.indptr.shape[0] != self.shape[0] + 1 or self.indices.shape[0] != self.data.shape[0]:
			raise ValueError(f"indptr {tuple(self.indptr.shape)} / indices {tuple(self.indices.shape)} do not fit shape {self.shape}")
		# The CSR tensor holds the values without their autograd history: gradients
		# reach ``data`` through ``ops.autograd``'s Function, never ``torch.sparse``'s own.
		self.csr = _sparse_csr(self.indptr, self.indices, self.data.detach(), self.shape)
		self._rowids = None
		self._csr_t = None

	@classmethod
	def from_numpy(cls, data, indices, indptr, shape, *, dtype=None, device="cuda") -> "CSROperator":
		"""From numpy ``data``, column ``indices`` and row pointers ``indptr`` (scipy's CSR arrays)."""
		return cls(torch.tensor(np.asarray(data), dtype=dtype, device=device), np.asarray(indices), np.asarray(indptr), shape)

	@classmethod
	def from_scipy(cls, A, dtype=None, device="cuda") -> "CSROperator":
		"""From any scipy sparse matrix: converted to CSR, duplicates summed, columns sorted."""
		A = A.tocsr(copy=True)
		A.sum_duplicates()
		return cls.from_numpy(A.data, A.indices, A.indptr, A.shape, dtype=dtype, device=device)

	@classmethod
	def from_dense(cls, A, tol: float = 0.0, dtype=None, device="cuda") -> "CSROperator":
		"""From a dense matrix, keeping the entries with ``|a| > tol``."""
		import scipy.sparse as sps

		A = np.asarray(A)
		return cls.from_scipy(sps.csr_matrix(np.where(np.abs(A) > tol, A, 0)), dtype=dtype, device=device)

	@property
	def nnz(self) -> int:
		return int(self.data.shape[0])

	@property
	def rowids(self) -> torch.Tensor:
		"""The row of every stored entry."""
		if self._rowids is None:
			counts = (self.indptr[1:] - self.indptr[:-1]).long()
			self._rowids = torch.repeat_interleave(torch.arange(self.shape[0], device=self.device), counts)
		return self._rowids

	def float_tensors(self) -> tuple:
		return (self.data,)

	def transpose_csr(self) -> torch.Tensor:
		"""``Aᵀ`` as a CSR tensor (the input gradient's operand), its structure built once."""
		if self._csr_t is None:
			cols = self.indices.long()
			perm = torch.argsort(cols, stable=True)
			counts = torch.bincount(cols, minlength=self.shape[1])
			indptr = torch.cat([torch.zeros(1, dtype=torch.long, device=self.device), torch.cumsum(counts, 0)])
			self._csr_t = (perm, indptr.to(self.indptr.dtype), self.rowids[perm].to(self.indices.dtype))
		perm, indptr, indices = self._csr_t
		return _sparse_csr(indptr, indices, self.data.detach()[perm], (self.shape[1], self.shape[0]))

	def _matmat(self, V: torch.Tensor) -> torch.Tensor:
		V = torch.as_tensor(V, dtype=self.dtype, device=self.device)
		if not V.is_contiguous():
			V = V.contiguous()
			LAYOUT_COPIES["csr_spmm"] += 1
		return csr_spmm_ad(self.data, V, self)

	def matvec(self, v: torch.Tensor) -> torch.Tensor:
		v = torch.as_tensor(v, dtype=self.dtype, device=self.device)
		return self._matmat(v[:, None])[:, 0] if v.ndim == 1 else self._matmat(v)

	def matmat_t(self, Vt: torch.Tensor) -> torch.Tensor:
		Y = self._matmat(torch.as_tensor(Vt, device=self.device).T)
		LAYOUT_COPIES["csr_spmm"] += 1
		return Y.T.contiguous()

	def rmatmat(self, V: torch.Tensor) -> torch.Tensor:
		"""Adjoint apply ``A† V`` (plain PyTorch: gather by row, ``index_add_`` by column)."""
		V = torch.as_tensor(V, dtype=self.dtype, device=self.device)
		single = V.ndim == 1
		V = V[:, None] if single else V
		prod = self.data.conj()[:, None] * V[self.rowids]
		out = torch.zeros((self.shape[1], V.shape[1]), dtype=prod.dtype, device=self.device)
		out.index_add_(0, self.indices.long(), prod)
		return out[:, 0] if single else out

	def rmatvec(self, v: torch.Tensor) -> torch.Tensor:
		return self.rmatmat(v)

	def todense(self) -> torch.Tensor:
		return self.csr.to_dense()

	def _scipy(self):
		import scipy.sparse as sps

		return sps.csr_matrix((self.data.cpu().numpy(), self.indices.cpu().numpy(), self.indptr.cpu().numpy()), shape=self.shape)

	def tobsr(self, blocksize: Tuple[int, int] = (8, 128)) -> "BSROperator":
		"""The same matrix as a :class:`BSROperator` of ``blocksize`` tiles (through scipy)."""
		return BSROperator.from_scipy(self._scipy(), blocksize=blocksize, dtype=self.dtype, device=self.device)


class COOOperator(LinearOperator):
	"""Coordinate-format operator: ``(data, row, col)`` triplets
	(``primate_tpu/operators/sparse.py:100-150``). Repeated coordinates add up. The
	applies run through a CSR tensor built from the triplets once, as :class:`CSROperator`'s do."""

	def __init__(self, data: torch.Tensor, row, col, shape: Tuple[int, int]):
		self.data = data.contiguous()
		self.dtype, self.device = self.data.dtype, self.data.device
		self.shape = tuple(int(s) for s in shape)
		self.row = torch.as_tensor(row, device=self.device).long()
		self.col = torch.as_tensor(col, device=self.device).long()
		# Coalesce by a sort of the linear keys and an index_add of the values, an
		# ordinary differentiable op: gradients reach ``data`` through the CSR values.
		keys, inverse = torch.unique(self.row * self.shape[1] + self.col, sorted=True, return_inverse=True)
		values = torch.zeros(keys.shape[0], dtype=self.dtype, device=self.device).index_add(0, inverse, self.data)
		r, c = keys // self.shape[1], keys % self.shape[1]
		counts = torch.bincount(r, minlength=self.shape[0])
		indptr = torch.cat([torch.zeros(1, dtype=torch.long, device=self.device), torch.cumsum(counts, 0)])
		self._csr = CSROperator(values, c, indptr, self.shape)

	@classmethod
	def from_scipy(cls, A, dtype=None, device="cuda") -> "COOOperator":
		A = A.tocoo()
		return cls(torch.tensor(A.data, dtype=dtype, device=device), A.row, A.col, A.shape)

	@classmethod
	def from_dense(cls, A, tol: float = 0.0, dtype=None, device="cuda") -> "COOOperator":
		"""From a dense matrix, keeping the entries with ``|a| > tol``."""
		A = np.asarray(A)
		r, c = np.nonzero(np.abs(A) > tol)
		return cls(torch.tensor(A[r, c], dtype=dtype, device=device), r, c, A.shape)

	@property
	def nnz(self) -> int:
		return int(self.data.shape[0])

	def float_tensors(self) -> tuple:
		# The coalesced values, computed from ``data``: autograd carries their gradient on to ``data``.
		return self._csr.float_tensors()

	def _matmat(self, V: torch.Tensor) -> torch.Tensor:
		return self._csr._matmat(V)

	def matvec(self, v: torch.Tensor) -> torch.Tensor:
		return self._csr.matvec(v)

	def matmat_t(self, Vt: torch.Tensor) -> torch.Tensor:
		return self._csr.matmat_t(Vt)

	def rmatmat(self, V: torch.Tensor) -> torch.Tensor:
		return self._csr.rmatmat(V)

	def rmatvec(self, v: torch.Tensor) -> torch.Tensor:
		return self._csr.rmatmat(v)

	def todense(self) -> torch.Tensor:
		out = torch.zeros(self.shape, dtype=self.dtype, device=self.device)
		return out.index_put_((self.row, self.col), self.data, accumulate=True)


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
		self._adj = None

	@classmethod
	def from_numpy(cls, blocks, indices, indptr, shape, *, dtype=None, device="cuda") -> "BSROperator":
		"""From numpy tiles ``(nnzb, bm, bn)``, block-column ids and block-row pointers."""
		return cls(torch.tensor(np.asarray(blocks), dtype=dtype, device=device), np.asarray(indices), np.asarray(indptr), shape)

	@classmethod
	def from_scipy(
		cls, A, blocksize: Optional[Tuple[int, int]] = None, dtype=None, device="cuda", engine: str = "auto"
	) -> "BSROperator":
		"""From a scipy sparse (or dense) matrix (``primate_tpu/operators/sparse.py:528-556``),
		zero-padded to whole tiles, duplicates summed, each block row's tiles sorted by
		block column. An empty block row stores no tile: the kernel writes its zeros.

		``engine``: ``"native"`` converts in one pass with the C++ loader
		(:mod:`~primate_tpu_torch.native`, and raises when it cannot be built),
		``"scipy"`` through ``tobsr``. ``"auto"`` takes scipy's route (the JAX package takes
		the loader's): ``tobsr`` is one C++ pass, and it beat the loader on a 1M-row BSR
		matrix (``chip_smoke.py`` phase 16). Both store the same tiles bit for bit (the
		native loader's zero tiles for empty block rows are dropped). Complex values take scipy's route (``"native"`` raises),
		and so does a call without ``blocksize``, where scipy picks the tiles."""
		import scipy.sparse as sps

		if not sps.issparse(A):
			A = sps.csr_matrix(np.asarray(A))
		shape = A.shape
		nnz_logical = int(A.nnz)  # before tobsr: a BSR matrix's nnz counts stored tile entries
		parts = None
		if blocksize is not None:
			parts = _native_parts("scipy" if engine == "auto" else engine, A, lambda nat: nat.csr_to_bsr_arrays(A, *blocksize))
		if parts is not None:
			blocks, indices, indptr = _drop_coverage_tiles(A, blocksize[0], *parts)
		else:
			A = sps.csr_matrix(A)
			A.sum_duplicates()
			if blocksize is not None:
				bm, bn = blocksize
				padded = (-(-shape[0] // bm) * bm, -(-shape[1] // bn) * bn)
				if padded != shape:
					A.resize(padded)
			A = A.tobsr(blocksize=blocksize) if blocksize is not None else A.tobsr()
			A.sort_indices()
			blocks, indices, indptr = A.data, A.indices, A.indptr
		op = cls.from_numpy(blocks, indices, indptr, shape, dtype=dtype, device=device)
		op._warn_fill_in(nnz_logical)
		return op

	@classmethod
	def from_dense(cls, A, blocksize: Tuple[int, int] = (8, 128), dtype=None, device="cuda") -> "BSROperator":
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

	def float_tensors(self) -> tuple:
		return (self.blocks,)

	def _matmat(self, V: torch.Tensor) -> torch.Tensor:
		V = torch.as_tensor(V, dtype=self.dtype, device=self.device)
		if not V.is_contiguous():
			V = V.contiguous()
			LAYOUT_COPIES["bsr_spmm"] += 1
		return bsr_spmm_ad(self.blocks, V, self.indptr, self.indices, self.shape[0])

	def _transpose(self):
		"""Tiles, block-row pointers and block-column ids of ``A†`` (each tile conjugate-transposed,
		sorted by block column), built once per operator, or per call while the tiles carry a gradient."""
		track = self.blocks.requires_grad and torch.is_grad_enabled()
		if self._adj is None or track:
			with torch.set_grad_enabled(track):
				blocks_t, indptr_t, indices_t = bsr_transpose(self.blocks, self.indptr, self.indices, self.shape[1])
				if blocks_t.is_complex():
					blocks_t = torch.conj_physical(blocks_t)
			if track:
				return blocks_t, indptr_t, indices_t
			self._adj = (blocks_t, indptr_t, indices_t)
		return self._adj

	def rmatmat(self, V: torch.Tensor) -> torch.Tensor:
		"""Adjoint block apply ``A† V``: the BSR kernel on the transposed tiles (:meth:`_transpose`,
		node-major; a block that is not contiguous is copied once, counted in
		``LAYOUT_COPIES["bsr_spmm"]``), its plain version on a CPU tensor."""
		V = torch.as_tensor(V, dtype=self.dtype, device=self.device)
		single = V.ndim == 1
		V = V[:, None] if single else V
		if not V.is_contiguous():
			V = V.contiguous()
			LAYOUT_COPIES["bsr_spmm"] += 1
		blocks_t, indptr_t, indices_t = self._transpose()
		bm = self.blocksize[0]
		n_brow = self.indptr.shape[0] - 1
		if n_brow * bm > -(-V.shape[0] // bm) * bm:  # block rows past the logical rows: zero rows of V
			Vp = torch.zeros((n_brow * bm, V.shape[1]), dtype=V.dtype, device=V.device)
			Vp[: V.shape[0]] = V
			V = Vp
		out = bsr_spmm_ad(blocks_t, V, indptr_t, indices_t, self.shape[1])
		return out[:, 0] if single else out

	def rmatmat_plain(self, V: torch.Tensor) -> torch.Tensor:
		"""Plain PyTorch ``A† V`` (the reference the tests hold :meth:`rmatmat` to): gather by block row, tile product, ``index_add_`` by block column."""
		bm, bn = self.blocksize
		V = torch.as_tensor(V, device=self.device)
		single = V.ndim == 1
		V = V[:, None] if single else V
		k = V.shape[1]
		n_brow = self.indptr.shape[0] - 1
		np_c = self.pshape[1]
		acc = torch.promote_types(self.dtype, torch.float32)
		Vp = torch.zeros((n_brow * bm, k), dtype=acc, device=self.device)
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
		self._adj = None

	@classmethod
	def from_numpy(cls, bands, offsets, shape, *, dtype=None, device="cuda") -> "DIAOperator":
		"""From row-aligned numpy bands ``(n_diags, n)`` (e.g. ``np.asarray(jax_op.bands)``)."""
		return cls(torch.tensor(np.asarray(bands), dtype=dtype, device=device), offsets, shape)

	@classmethod
	def from_scipy(cls, A, dtype=None, device="cuda", engine: str = "auto") -> "DIAOperator":
		"""From a scipy sparse matrix (``primate_tpu/operators/sparse.py:721-745``): ``engine``
		``"native"`` through the C++ loader (:mod:`~primate_tpu_torch.native`; raises when it
		cannot be built), ``"scipy"`` through ``A.todia()``, ``"auto"`` natively when the loader
		builds. Both give the same offsets (ascending) and bands bit for bit; complex values
		take scipy's route (``"native"`` raises)."""
		parts = _native_parts(engine, A, lambda nat: nat.csr_to_dia_arrays(A))
		if parts is not None:
			offsets, bands = parts
			return cls.from_numpy(bands, offsets, A.shape, dtype=dtype, device=device)
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

	def float_tensors(self) -> tuple:
		return (self.bands,)

	def matmat_t(self, Vt: torch.Tensor) -> torch.Tensor:
		"""Probe-major stencil ``out[b, i] = Σ_d band_d[i]·Vt[b, i + off_d]`` (kernel A on the card)."""
		Vt = torch.as_tensor(Vt, dtype=self.dtype, device=self.device).contiguous()
		return dia_stencil_t_ad(self.bands, Vt, self.offsets_t, self.offsets)

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
			return dia_stencil_t_ad(self.bands, V.T, self.offsets_t, self.offsets).T
		return dia_stencil_ad(self.bands, V.contiguous(), self.offsets_t, self.offsets)

	def matvec(self, v: torch.Tensor) -> torch.Tensor:
		v = torch.as_tensor(v, device=self.device)
		if v.ndim != 1:
			return self._matmat(v)
		return self.matmat_t(v[None, :])[0]

	def _adjoint(self):
		"""Bands, device offsets and host offsets of ``A†`` (``band'_{−d}[i] = conj(band_d[i − d])``),
		built once per operator, or per call while the bands carry a gradient."""
		track = self.bands.requires_grad and torch.is_grad_enabled()
		if self._adj is None or track:
			with torch.set_grad_enabled(track):
				adj, offsets = dia_adjoint(self.bands, self.offsets)
				if adj.is_complex():
					adj = torch.conj_physical(adj)
			entry = (adj, -self.offsets_t, offsets)
			if track:
				return entry
			self._adj = entry
		return self._adj

	def rmatmat(self, V: torch.Tensor) -> torch.Tensor:
		"""Adjoint apply ``A† V`` of an ``(n, k)`` block (or a vector): the stencils on the adjoint
		bands (:meth:`_adjoint`), picked by the block's layout as :meth:`_matmat` picks them
		(their plain versions on a CPU tensor)."""
		V = torch.as_tensor(V, dtype=self.dtype, device=self.device)
		if V.ndim == 1:
			return self.rmatmat_t(V[None, :])[0]
		if V.T.is_contiguous() and not V.is_contiguous():
			return self.rmatmat_t(V.T).T
		adj, offsets_t, offsets = self._adjoint()
		return dia_stencil_ad(adj, V.contiguous(), offsets_t, offsets)

	def rmatmat_t(self, Ut: torch.Tensor) -> torch.Tensor:
		"""Probe-major adjoint apply ``(A† Utᵀ)ᵀ`` on a ``(k, n)`` block."""
		Ut = torch.as_tensor(Ut, dtype=self.dtype, device=self.device)
		adj, offsets_t, offsets = self._adjoint()
		return dia_stencil_t_ad(adj, Ut.contiguous(), offsets_t, offsets)

	def rmatvec(self, v: torch.Tensor) -> torch.Tensor:
		return self.rmatmat(v)

	def rmatmat_plain(self, V: torch.Tensor) -> torch.Tensor:
		"""Plain PyTorch ``A† V`` (``(n,)`` or ``(n, k)``; the reference the tests hold :meth:`rmatmat`
		to): one slice product per band,
		accumulated in ``promote_types(dtype, float32)``."""
		n = self.shape[0]
		V = torch.as_tensor(V, device=self.device)
		single = V.ndim == 1
		V = V[:, None] if single else V
		acc = torch.promote_types(self.dtype, torch.float32)
		out = torch.zeros((n, V.shape[1]), dtype=acc, device=self.device)
		for k, off in enumerate(self.offsets):
			lo, hi = max(0, -off), min(n, n - off)
			if lo < hi:
				out[lo + off : hi + off] += self.bands[k, lo:hi, None].conj().to(acc) * V[lo:hi].to(acc)
		out = out.to(self.dtype)
		return out[:, 0] if single else out

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
		"""Step ``v = A·q_cur − β·q_prev``, ``α = Σ v·q_cur`` (pass A of the step kernels on the card).
		A complex (Hermitian) operator takes the base class's step: the complex stencil
		``dia_stencil_t`` (counted in ``LAUNCHES``) and PyTorch; the step kernels are real only."""
		if self.dtype.is_complex:
			return super().lanczos_step(q_cur, q_prev, beta)
		return lanczos_dia_step(self.bands, self.offsets_t, q_cur, q_prev, beta)

	def lanczos_sweep_step(self, v_cur, v_prev, state, alpha_out, beta_out, residual_tol: float) -> torch.Tensor:
		"""The whole step without re-orthogonalisation (both step kernels on the card); a
		complex operator takes the base class's step, through the complex ``dia_stencil_t``."""
		if self.dtype.is_complex:
			return super().lanczos_sweep_step(v_cur, v_prev, state, alpha_out, beta_out, residual_tol)
		return lanczos_dia_sweep_step(self.bands, self.offsets_t, v_cur, v_prev, state, alpha_out, beta_out, residual_tol)


def _drop_coverage_tiles(A, bm: int, blocks: np.ndarray, indices: np.ndarray, indptr: np.ndarray):
	"""The native loader's tiles without its zero coverage tile in each block row that holds
	no stored entry (one tile each there): scipy's layout, which the kernel reads."""
	import scipy.sparse as sps

	rp = sps.csr_matrix(A).indptr
	n_brow = indptr.shape[0] - 1
	edges = np.minimum(np.arange(n_brow + 1, dtype=np.int64) * bm, A.shape[0])
	empty = rp[edges[1:]] == rp[edges[:-1]]
	if not empty.any():
		return blocks, indices, indptr
	counts = np.diff(indptr)
	keep = np.repeat(~empty, counts)
	new_counts = np.where(empty, 0, counts)
	new_indptr = np.zeros_like(indptr)
	np.cumsum(new_counts, out=new_indptr[1:])
	return blocks[keep], indices[keep], new_indptr


class GramOperator(LinearOperator):
	"""Gram operator ``A†A`` (``transpose_first=True``) or ``AA†`` of a rectangular ``A``,
	never formed (``primate_tpu/operators/sparse.py:913-951``): two applies of ``A`` per
	product, the probe-major ``matmat_t`` through the data operator's own ``matmat_t`` and
	``rmatmat_t``. ``MatrixFunction.quad`` and ``spectral_density`` of a Gram operator
	go through Golub-Kahan bidiagonalisation of ``A`` instead (:mod:`~primate_tpu_torch.bidiag`)."""

	def __init__(self, A, transpose_first: bool = True, device="cuda"):
		self.A = aslinop(A, device=device)
		self.transpose_first = bool(transpose_first)
		n = self.A.shape[1] if self.transpose_first else self.A.shape[0]
		self.shape = (n, n)
		self.dtype, self.device = self.A.dtype, self.A.device

	def float_tensors(self) -> tuple:
		return self.A.float_tensors()

	def _matmat(self, V: torch.Tensor) -> torch.Tensor:
		if self.transpose_first:
			return self.A.rmatmat(self.A.matmat(V))
		return self.A.matmat(self.A.rmatmat(V))

	def matmat_t(self, Vt: torch.Tensor) -> torch.Tensor:
		if self.transpose_first:
			return self.A.rmatmat_t(self.A.matmat_t(Vt))
		return self.A.matmat_t(self.A.rmatmat_t(Vt))
