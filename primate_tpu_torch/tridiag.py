"""Batched symmetric tridiagonal eigensolves.

Counterpart of ``primate_tpu/tridiag.py:48-75``. The Jacobi matrices of a
Lanczos sweep are small (deg × deg) and come in batches of nv probes, so each
is densified and the batch goes to ``torch.linalg.eigh``, as the JAX package
leaves it to ``jnp.linalg.eigh``.
"""

from typing import Tuple

import torch

__all__ = ["tridiag_matrix", "eigh_tridiag"]


def _normalize_offdiag(d: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
	"""The length ``deg-1`` off-diagonal; also accepts a length-deg ``e`` with a leading zero."""
	if e.shape[-1] == d.shape[-1]:
		return e[..., 1:]
	if e.shape[-1] != d.shape[-1] - 1:
		raise ValueError("Invalid diagonal/subdiagonal pair")
	return e


def tridiag_matrix(d: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
	"""Densify ``d (..., deg)`` and off-diagonals ``e`` into ``(..., deg, deg)`` symmetric tridiagonals."""
	e = _normalize_offdiag(d, e)
	return torch.diag_embed(d) + torch.diag_embed(e, offset=1) + torch.diag_embed(e, offset=-1)


def eigh_tridiag(d: torch.Tensor, e: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
	"""Eigenpairs ``(rw (..., deg), Y (..., deg, deg))`` of the tridiagonals ``T(d, e)``, batched."""
	return torch.linalg.eigh(tridiag_matrix(d, e))
