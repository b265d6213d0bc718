"""Operator preparation: the Gershgorin spectral enclosure.

Counterpart of ``gershgorin_interval`` in ``primate_tpu/operators/prepare.py:34-95``,
the deterministic interval of ``ChebyshevFunction`` / ``kpm_*(interval="gershgorin")``.
The rest of that module (``auto_operator``, ``reorder_rcm``, ``bandwidth``) is not
ported yet. The entries are read where they lie (bands, CSR values, tiles or the
dense matrix, on the card or the CPU) and two floats come back.
"""

from typing import Tuple

import numpy as np
import torch

from .base import DenseOperator, LinearOperator
from .sparse import BSROperator, COOOperator, CSROperator, DIAOperator

__all__ = ["gershgorin_interval"]


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
