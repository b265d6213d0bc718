"""Operator preparation: the storage-format choice with a bandwidth-reducing reordering,
and the Gershgorin spectral enclosure.

Counterpart of ``primate_tpu/operators/prepare.py``. On the card the format is the
performance model: a DIA operator applies by the stencil kernels with no gathers, a
BSR operator by the tile kernel, a CSR operator by cuSPARSE. Many matrices are
banded in the right ordering (mesh and graph Laplacians under reverse
Cuthill-McKee), and the spectral sums this package estimates are invariant under a
symmetric permutation, ``tr f(P A Pᵀ) = tr f(A)``: :func:`auto_operator` measures the
structure (the native loader's one-pass analysis, or numpy), reorders where that makes
the matrix banded, picks the format and reports what it did in a :class:`PrepInfo`.
Per-coordinate outputs (diagonals, f(A)v) come back in the permuted basis:
``PrepInfo.unpermute`` maps them back.

``gershgorin_interval`` (``primate_tpu/operators/prepare.py:34-95``) is the
deterministic interval of ``ChebyshevFunction`` / ``kpm_*(interval="gershgorin")``:
the entries are read where they lie (bands, CSR values, tiles or the dense matrix,
on the card or the CPU) and two floats come back.
"""

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .base import DenseOperator, LinearOperator
from .sparse import BSROperator, COOOperator, CSROperator, DIAOperator

__all__ = ["PrepInfo", "auto_operator", "bandwidth", "gershgorin_interval", "reorder_rcm"]


def _enclosure(diag: torch.Tensor, radius: torch.Tensor) -> Tuple[float, float]:
	diag = torch.real(diag).to(radius.dtype)  # Hermitian operators have a real diagonal
	return float(torch.min(diag - radius)), float(torch.max(diag + radius))


def _row_sums(rows: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
	"""Diagonal and off-diagonal absolute row sums of the entries ``(rows, cols, vals)``."""
	on = rows == cols
	absv = torch.abs(vals)
	diag = torch.zeros(n, dtype=vals.dtype, device=vals.device).index_add_(0, rows[on], vals[on])
	total = torch.zeros(n, dtype=absv.dtype, device=vals.device).index_add_(0, rows, absv)
	return diag, total - torch.abs(diag)


def gershgorin_interval(A) -> Tuple[float, float]:
	"""Deterministic spectral enclosure ``[min(aᵢᵢ−Rᵢ), max(aᵢᵢ+Rᵢ)]``, ``Rᵢ = Σ_{j≠i}|aᵢⱼ|``.

	Every eigenvalue lies within ``Rᵢ`` of some diagonal entry, so unlike the
	Rayleigh-Ritz estimate the interval is guaranteed to hold the spectrum: the safe
	choice for a Chebyshev recurrence, which diverges on an eigenvalue outside the
	mapped [−1, 1]. Takes DIA, CSR, COO, BSR and dense operators, tensors, numpy
	arrays and scipy sparse matrices; an implicit operator raises ``TypeError``.
	"""
	import scipy.sparse as sps

	if isinstance(A, DIAOperator):
		n = A.shape[0]
		off = [k for k, o in enumerate(A.offsets) if o != 0]
		radius = torch.sum(torch.abs(A.bands[off]), dim=0) if off else torch.zeros(n, dtype=A.bands.real.dtype, device=A.device)
		diag = A.bands[A.offsets.index(0)] if 0 in A.offsets else torch.zeros(n, dtype=A.dtype, device=A.device)
		return _enclosure(diag, radius)
	if isinstance(A, COOOperator):
		A = A._csr  # duplicates summed, as scipy's tocsr sums them
	if isinstance(A, CSROperator):
		return _enclosure(*_row_sums(A.rowids, A.indices.long(), A.data, A.shape[0]))
	if isinstance(A, BSROperator):
		bm, bn = A.blocksize
		rows = (A.rowids[:, None, None] * bm + torch.arange(bm, device=A.device)[None, :, None]).expand(A.blocks.shape)
		cols = (A.indices[:, None, None] * bn + torch.arange(bn, device=A.device)[None, None, :]).expand(A.blocks.shape)
		keep = (rows < A.shape[0]) & (cols < A.shape[1])  # tiles may overhang the logical shape
		return _enclosure(*_row_sums(rows[keep], cols[keep], A.blocks[keep], A.shape[0]))
	if isinstance(A, DenseOperator):
		A = A.A
	if isinstance(A, torch.Tensor):
		diag = torch.diagonal(A)
		return _enclosure(diag, torch.sum(torch.abs(A), dim=1) - torch.abs(diag))
	if sps.issparse(A):
		S = A.tocsr()
		diag = S.diagonal()
		radius = np.asarray(np.abs(S).sum(axis=1)).ravel() - np.abs(diag)
	elif isinstance(A, np.ndarray):
		diag = np.diag(A)
		radius = np.abs(A).sum(axis=1) - np.abs(diag)
	else:
		kind = "implicit operator" if isinstance(A, LinearOperator) else type(A).__name__
		raise TypeError(f"gershgorin_interval needs access to the matrix entries; got {kind}")
	diag = np.real(diag)
	return float(np.min(diag - radius)), float(np.max(diag + radius))


class PrepInfo(NamedTuple):
	"""What :func:`auto_operator` chose (``primate_tpu/operators/prepare.py:99-148``).

	format: "dense" | "dia" | "bsr" | "csr". perm: the permutation applied
	(``B = A[perm][:, perm]``), or None for the natural order. bandwidth: max |i − j| over
	the stored nonzeros in the chosen order. fill: stored values over logical nonzeros of
	the chosen format (1.0 = no padding).
	"""

	format: str
	perm: Optional[np.ndarray]
	bandwidth: int
	fill: float

	def _index(self, x):
		return torch.as_tensor(np.ascontiguousarray(self.perm), device=x.device) if isinstance(x, torch.Tensor) else self.perm

	def unpermute(self, x, axis: int = 0):
		"""A per-coordinate result (a diagonal, a matvec) back in the original order:
		``out[perm] = x`` along ``axis``; numpy arrays and tensors."""
		if self.perm is None:
			return x
		if not isinstance(x, torch.Tensor):
			x = np.asarray(x)
		out = torch.empty_like(x) if isinstance(x, torch.Tensor) else np.empty_like(x)
		idx = [slice(None)] * x.ndim
		idx[axis] = self._index(x)
		out[tuple(idx)] = x
		return out

	def permute(self, x, axis: int = 0):
		"""Original-order coordinates in the operator's order (``x[perm]`` along ``axis``),
		e.g. a start vector; numpy arrays and tensors."""
		if self.perm is None:
			return x
		if not isinstance(x, torch.Tensor):
			x = np.asarray(x)
		idx = [slice(None)] * x.ndim
		idx[axis] = self._index(x)
		return x[tuple(idx)]


def _analyze(A, blocksize: Tuple[int, int] = (8, 8)) -> dict:
	"""``{"n_diags", "bandwidth", "n_tiles", "max_row_nnz"}`` of a scipy CSR matrix: the
	native one-pass analysis when the loader builds, else numpy (which holds an array of
	one offset per nonzero)."""
	from .. import native

	if A.nnz == 0:
		return {"n_diags": 0, "bandwidth": 0, "n_tiles": 0, "max_row_nnz": 0}
	stats = native.csr_analyze(A, *blocksize)
	if stats is not None:
		return stats
	n, m = A.shape
	bm, bn = blocksize
	rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(A.indptr))
	cols = A.indices.astype(np.int64)
	uniq = np.unique(cols - rows)
	tiles = np.unique(rows // bm * (1 + (m - 1) // bn) + cols // bn)
	return {
		"n_diags": len(uniq),
		"bandwidth": int(np.abs(uniq).max()),
		"n_tiles": len(tiles),
		"max_row_nnz": int(np.diff(A.indptr).max()),
	}


def bandwidth(A) -> int:
	"""Max ``|i − j|`` over the stored nonzeros of a scipy or dense matrix (0 for a diagonal or empty one)."""
	import scipy.sparse as sps

	A = A.tocsr() if sps.issparse(A) else sps.csr_matrix(np.asarray(A))
	return _analyze(A)["bandwidth"]


def reorder_rcm(A):
	"""Reverse Cuthill-McKee order of a square sparse matrix, computed on the symmetrised
	structure (scipy's ``reverse_cuthill_mckee``): ``(A[perm][:, perm]`` as CSR, ``perm)``."""
	import scipy.sparse as sps
	from scipy.sparse.csgraph import reverse_cuthill_mckee

	A = A.tocsr() if sps.issparse(A) else sps.csr_matrix(np.asarray(A))
	if A.shape[0] != A.shape[1]:
		raise ValueError(f"RCM needs a square matrix, got {A.shape}")
	perm = np.ascontiguousarray(reverse_cuthill_mckee((A + A.T).tocsr(), symmetric_mode=True))
	return A[perm][:, perm].tocsr(), perm


def auto_operator(
	A,
	dtype=None,
	reorder: str = "auto",
	dense_density: float = 0.125,
	dense_n: int = 512,
	dia_fill_limit: float = 4.0,
	bsr_fill_limit: float = 1.5,
	blocksize: Tuple[int, int] = (8, 8),
	device="cuda",
) -> Tuple[LinearOperator, PrepInfo]:
	"""The storage format the card applies fastest, reordering if that helps
	(``primate_tpu/operators/prepare.py:189-278``); the operator lives on ``device``.

	The ladder, each step falling through when its fill bound fails:

	1. **dense**: density ≥ ``dense_density`` or ``max(n, m) ≤ dense_n`` (a GEMM).
	2. **dia**: the band fill ``n_diags·n / nnz`` ≤ ``dia_fill_limit`` in the natural
	   order, or after RCM unless ``reorder="never"`` (the stencil kernels).
	3. **bsr**: ``blocksize`` tiles with fill ≤ ``bsr_fill_limit`` (the tile kernel).
	4. **csr**: the general path (cuSPARSE).

	``reorder``: "auto" keeps RCM only where it unlocks DIA, "always" keeps it for the
	BSR and CSR fallbacks too when it narrows the band, "never" skips it. Returns
	``(operator, PrepInfo)``; with ``PrepInfo.perm`` set the operator is
	``A[perm][:, perm]``, of the same spectrum.
	"""
	import scipy.sparse as sps

	from .base import torch_dtype

	if reorder not in ("auto", "always", "never"):
		raise ValueError(f"reorder must be 'auto' | 'always' | 'never', got {reorder!r}")
	tdtype = torch_dtype(dtype)

	if not sps.issparse(A):
		Ad = torch.as_tensor(np.asarray(A), dtype=tdtype, device=device)
		return DenseOperator(Ad), PrepInfo("dense", None, max(Ad.shape[0] - 1, 0), 1.0)

	A = A.tocsr()
	n, m = A.shape
	square = n == m
	density = A.nnz / max(n * m, 1)
	if density >= dense_density or max(n, m) <= dense_n:
		Ad = torch.as_tensor(A.toarray(), dtype=tdtype, device=device)
		return DenseOperator(Ad), PrepInfo("dense", None, max(n - 1, 0), 1.0)

	perm: Optional[np.ndarray] = None
	stats = _analyze(A, blocksize)
	if square and A.nnz:
		fill_nat = stats["n_diags"] * n / A.nnz
		if fill_nat <= dia_fill_limit:
			op = DIAOperator.from_scipy(A, dtype=tdtype, device=device)
			return op, PrepInfo("dia", None, stats["bandwidth"], fill_nat)
		if reorder != "never":
			A_rcm, p = reorder_rcm(A)
			stats_rcm = _analyze(A_rcm, blocksize)
			fill_rcm = stats_rcm["n_diags"] * n / A.nnz
			if fill_rcm <= dia_fill_limit:
				op = DIAOperator.from_scipy(A_rcm, dtype=tdtype, device=device)
				return op, PrepInfo("dia", p, stats_rcm["bandwidth"], fill_rcm)
			if reorder == "always" and stats_rcm["bandwidth"] < stats["bandwidth"]:
				A, perm, stats = A_rcm, p, stats_rcm

	if A.nnz and stats["n_tiles"] * blocksize[0] * blocksize[1] / A.nnz <= bsr_fill_limit:
		op = BSROperator.from_scipy(A, blocksize=blocksize, dtype=tdtype, device=device)
		fill = op.blocks.shape[0] * blocksize[0] * blocksize[1] / A.nnz
		return op, PrepInfo("bsr", perm, stats["bandwidth"], fill)

	op = CSROperator.from_scipy(A, dtype=tdtype, device=device)
	return op, PrepInfo("csr", perm, stats["bandwidth"] if square else max(n, m) - 1, 1.0)
