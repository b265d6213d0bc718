"""Carry operators and estimator state across from the JAX package, as numpy arrays.

This module imports neither package: it takes what ``np.asarray`` makes of a
JAX operator's or state's arrays, e.g.::

    op = dia_from_numpy(np.asarray(jax_op.bands), jax_op.offsets, jax_op.shape, device="cuda")
    op = bsr_from_numpy(np.asarray(jax_op.blocks), np.asarray(jax_op.indices), np.asarray(jax_op.indptr), jax_op.shape)
    st = cov_state_from_numpy(int(s.n), np.asarray(s.mu), np.asarray(s.S))
"""

import numpy as np
import torch

from .operators.sparse import BSROperator, DIAOperator
from .stats import CovState

__all__ = ["dia_from_numpy", "bsr_from_numpy", "cov_state_from_numpy"]


def dia_from_numpy(bands, offsets, shape, *, device="cpu", dtype=None) -> DIAOperator:
	"""A :class:`DIAOperator` from row-aligned bands ``(n_diags, n)``, offsets and shape."""
	return DIAOperator.from_numpy(bands, offsets, shape, dtype=dtype, device=device)


def bsr_from_numpy(blocks, indices, indptr, shape, *, device="cpu", dtype=None) -> BSROperator:
	"""A :class:`BSROperator` from tiles ``(nnzb, bm, bn)``, block-column ids, block-row pointers and the logical shape."""
	return BSROperator.from_numpy(blocks, indices, indptr, shape, dtype=dtype, device=device)


def cov_state_from_numpy(n, mu, S, *, device="cpu", dtype=None) -> CovState:
	"""A Welford :class:`CovState` from a JAX ``CovState``'s ``n``, ``mu (dim,)`` and ``S (dim, dim)``."""
	return CovState(
		n=int(n),
		mu=torch.tensor(np.asarray(mu), dtype=dtype, device=device),
		S=torch.tensor(np.asarray(S), dtype=dtype, device=device),
	)
