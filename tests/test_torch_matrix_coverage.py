"""Every operator kind × every estimator entry point of the port (``tests/test_matrix_coverage.py``).

The same ``tridiag(−1, 3, −1)`` at N = 48 goes through ``hutch``, ``hutchpp``, ``xtrace``, ``diag``,
``xdiag``, ``lanczos`` and ``solve`` as a raw tensor, a ``DenseOperator``, a ``FunctionOperator``, an
``AffineOperator``, COO, CSR, BSR 8×8, DIA and an identity ``MatrixFunction``, on the CPU in float64.
The two packages draw their probes from different generators (threefry against Philox), so the
values are held to the JAX suite's bounds around the closed form (trace 3N, diagonal 3), and to 1e-8
where the estimator is exact (``xtrace`` at m = n).
"""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import primate_tpu_torch as ptt
from primate_tpu_torch.operators import AffineOperator, DenseOperator, FunctionOperator
from primate_tpu_torch.operators.sparse import BSROperator, COOOperator, CSROperator, DIAOperator, GramOperator
from primate_tpu_torch.solvers import solve

torch.set_num_threads(1)
N = 48
TRACE_TRUE = 3.0 * N
DEV = "cpu"


def _np(x):
	return torch.as_tensor(x).cpu().numpy()


def _banded():
	return sps.diags([-np.ones(N - 1), 3.0 * np.ones(N), -np.ones(N - 1)], [-1, 0, 1]).tocsr()


def _operators():
	L = _banded()
	dense = torch.from_numpy(L.toarray())
	return {
		"tensor": lambda: dense,
		"dense_op": lambda: DenseOperator(dense, device=DEV),
		"function": lambda: FunctionOperator(lambda V: dense @ V, (N, N), dtype=dense.dtype, device=DEV),
		"affine": lambda: AffineOperator(dense, t=0.0, device=DEV),
		"coo": lambda: COOOperator.from_scipy(L.tocoo(), device=DEV),
		"csr": lambda: CSROperator.from_scipy(L, device=DEV),
		"bsr": lambda: BSROperator.from_scipy(L, blocksize=(8, 8), device=DEV),
		"dia": lambda: DIAOperator.from_scipy(L, device=DEV),
		"matrix_function": lambda: ptt.MatrixFunction(dense, fun="identity", deg=N, orth=-1, device=DEV),
	}


def _hutch(op):
	assert abs(float(ptt.hutch(op, seed=1, converge="count", count=384)) - TRACE_TRUE) < 12


def _hutchpp(op):
	assert abs(float(ptt.hutchpp(op, m=15, seed=2)) - TRACE_TRUE) < 10


def _xtrace(op):
	assert abs(float(ptt.xtrace(op, batch=16, seed=3)) - TRACE_TRUE) < 1e-8 * TRACE_TRUE  # exact at m = n


def _diag(op):
	d = _np(ptt.diag(op, seed=4, converge="count", count=384))
	assert d.shape == (N,) and np.abs(d - 3.0).mean() < 0.7


def _xdiag(op):
	xd = _np(ptt.xdiag(op, m=32, seed=5))
	assert xd.shape == (N,) and abs(xd.sum() - TRACE_TRUE) / TRACE_TRUE < 0.25


def _lanczos(op):
	a, b = ptt.lanczos(op, deg=16, orth=4, seed=6, device=DEV)
	assert a.shape[0] == 16 and torch.isfinite(a).all() and torch.isfinite(b).all()


def _solve(op):
	y = np.random.default_rng(7).normal(size=N)
	x = _np(solve(op, torch.from_numpy(y), rtol=1e-8))
	assert np.allclose(_banded() @ x, y, atol=1e-4)


ESTIMATORS = {"hutch": _hutch, "hutchpp": _hutchpp, "xtrace": _xtrace, "diag": _diag, "xdiag": _xdiag,
              "lanczos": _lanczos, "solve": _solve}


@pytest.mark.parametrize("estimator", list(ESTIMATORS))
@pytest.mark.parametrize("kind", list(_operators()))
def test_every_estimator_on_every_operator(kind, estimator):
	ESTIMATORS[estimator](_operators()[kind]())


def test_same_probes_give_the_same_estimate_in_every_format():
	"""One seed, one n, one dtype and one device draw the same probes, so the formats agree."""
	ests = {k: float(ptt.hutch(make(), seed=1, converge="count", count=64)) for k, make in _operators().items()}
	ref = ests["tensor"]
	assert all(abs(v - ref) <= 1e-10 * abs(ref) for v in ests.values()), ests


def test_gram_operator_spectral_sums():
	X = np.random.default_rng(8).normal(size=(N + 8, N)) / np.sqrt(N)
	G = GramOperator(torch.from_numpy(X), device=DEV)
	tr_true = float(np.trace(X.T @ X))
	assert abs(float(ptt.hutch(G, seed=9, converge="count", count=512)) - tr_true) < 0.2 * tr_true
	assert abs(float(ptt.xtrace(G, batch=16, seed=10)) - tr_true) < 1e-8 * tr_true  # exact at m = n


def test_xdiag_odd_budget():
	xd = ptt.xdiag(_operators()["tensor"](), m=33, seed=11)  # odd budget
	assert xd.shape == (N,) and np.isfinite(_np(xd)).all()
