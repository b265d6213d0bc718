"""Carry operators and estimator state across from the JAX package, as numpy arrays.

This module imports neither package: it takes what ``np.asarray`` makes of a
JAX operator's or state's arrays. Like every constructor of the port, these put
their tensors on the card unless the caller passes ``device="cpu"``::

    op = dia_from_numpy(np.asarray(jax_op.bands), jax_op.offsets, jax_op.shape)
    op = bsr_from_numpy(np.asarray(jax_op.blocks), np.asarray(jax_op.indices), np.asarray(jax_op.indptr), jax_op.shape)
    op = csr_from_numpy(np.asarray(jax_op.data), np.asarray(jax_op.indices), np.asarray(jax_op.indptr), jax_op.shape)
    op = coo_from_numpy(np.asarray(jax_op.data), np.asarray(jax_op.row), np.asarray(jax_op.col), jax_op.shape)
    st = cov_state_from_numpy(int(s.n), np.asarray(s.mu), np.asarray(s.S), device="cpu")
    ms = mean_state_from_numpy(int(m.n), np.asarray(m.mu), device="cpu")
    ms = mean_state_from_numpy(ckpt["state"]["n"], ckpt["state"]["mean"])   # a JAX EstimatorCheckpoint's payload
    pre = nystrom_from_numpy(np.asarray(jax_pre.U), np.asarray(jax_pre.coef))
    pre = diag_precond_from_numpy(np.asarray(jax_pre.inv_diag))
"""

import numpy as np
import torch

from .operators.sparse import BSROperator, COOOperator, CSROperator, DIAOperator
from .solvers import DiagPreconditioner, NystromPreconditioner
from .stats import CovState, MeanState

__all__ = [
	"dia_from_numpy", "bsr_from_numpy", "csr_from_numpy", "coo_from_numpy", "cov_state_from_numpy", "mean_state_from_numpy",
	"nystrom_from_numpy", "diag_precond_from_numpy",
]


def dia_from_numpy(bands, offsets, shape, *, device="cuda", dtype=None) -> DIAOperator:
	"""A :class:`DIAOperator` from row-aligned bands ``(n_diags, n)``, offsets and shape."""
	return DIAOperator.from_numpy(bands, offsets, shape, dtype=dtype, device=device)


def bsr_from_numpy(blocks, indices, indptr, shape, *, device="cuda", dtype=None) -> BSROperator:
	"""A :class:`BSROperator` from tiles ``(nnzb, bm, bn)``, block-column ids, block-row pointers and the logical shape."""
	return BSROperator.from_numpy(blocks, indices, indptr, shape, dtype=dtype, device=device)


def csr_from_numpy(data, indices, indptr, shape, *, device="cuda", dtype=None) -> CSROperator:
	"""A :class:`CSROperator` from values, column indices, row pointers and the shape."""
	return CSROperator.from_numpy(data, indices, indptr, shape, dtype=dtype, device=device)


def coo_from_numpy(data, row, col, shape, *, device="cuda", dtype=None) -> COOOperator:
	"""A :class:`COOOperator` from values, row and column indices and the shape."""
	return COOOperator(torch.tensor(np.asarray(data), dtype=dtype, device=device), np.asarray(row), np.asarray(col), shape)


def cov_state_from_numpy(n, mu, S, *, device="cuda", dtype=None) -> CovState:
	"""A Welford :class:`CovState` from a JAX ``CovState``'s ``n``, ``mu (dim,)`` and ``S (dim, dim)``."""
	return CovState(
		n=int(n),
		mu=torch.tensor(np.asarray(mu), dtype=dtype, device=device),
		S=torch.tensor(np.asarray(S), dtype=dtype, device=device),
	)


def mean_state_from_numpy(n, mu, *, device="cuda", dtype=None) -> MeanState:
	"""A Welford :class:`MeanState` from a JAX ``MeanState``'s ``n`` and ``mu (dim,)``."""
	return MeanState(n=int(np.asarray(n)), mu=torch.tensor(np.atleast_1d(np.asarray(mu)), dtype=dtype, device=device))


def nystrom_from_numpy(U, coef, *, device="cuda", dtype=None) -> NystromPreconditioner:
	"""A :class:`~primate_tpu_torch.solvers.NystromPreconditioner` from a JAX one's ``U (n, s)`` and ``coef (s,)``."""
	return NystromPreconditioner(
		U=torch.tensor(np.asarray(U), dtype=dtype, device=device), coef=torch.tensor(np.asarray(coef), dtype=dtype, device=device)
	)


def diag_precond_from_numpy(inv_diag, *, device="cuda", dtype=None) -> DiagPreconditioner:
	"""A Jacobi :class:`~primate_tpu_torch.solvers.DiagPreconditioner` from a JAX one's ``inv_diag (n,)``."""
	return DiagPreconditioner(torch.tensor(np.asarray(inv_diag), dtype=dtype, device=device))
