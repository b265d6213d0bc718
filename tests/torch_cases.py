"""Cases that the CPU suites and ``chip_smoke.py`` share, so that the card runs what the CPU tests hold.

Imports torch, numpy, scipy and the port, never JAX: ``chip_smoke.py`` imports this module on the card.

- The disjoint chains: a DIA ``tridiag(−1, 3, −1)`` cut every ``atoms`` rows, a symmetric direction on its
  bands that keeps the chains apart, and the float64 closed form of the directional derivative of
  ``Σ_p v_pᵀ log(A) v_p`` along it (``tests/test_torch_quad_grad.py``, phase 26 (a)).
- ``EDGE_CASES``: the edge shapes and refusals of ``tests/test_edge_cases.py`` that apply to the port,
  each a function of the device that asserts its limits and returns what it measured
  (``tests/test_torch_edge_cases.py``, phase 26 (c)).
"""

import functools
import time

import numpy as np
import scipy.sparse as sps
import scipy.sparse.linalg as spla
import torch

import primate_tpu_torch as ptt

# -- the disjoint chains ----------------------------------------------------------------------------


def chain_bands(chains: int, atoms: int) -> np.ndarray:
	"""Row-aligned bands (offsets −1, 0, 1; ``band[k][i] = A[i, i + off_k]``) of tridiag(−1, 3, −1) with the
	coupling cut every ``atoms`` rows."""
	n = chains * atoms
	up = -np.ones(n)
	up[atoms - 1 :: atoms] = 0.0
	bands = np.zeros((3, n))
	bands[0, 1:], bands[1], bands[2] = up[:-1], 3.0, up
	return bands


def chain_direction(chains: int, atoms: int, seed: int) -> np.ndarray:
	"""A seeded symmetric direction on the chain bands that keeps the chains apart."""
	n = chains * atoms
	rng = np.random.default_rng(seed)
	hd, hu = rng.normal(size=n), rng.normal(size=n)
	hu[atoms - 1 :: atoms] = 0.0
	H = np.zeros((3, n))
	H[0, 1:], H[1], H[2] = hu[:-1], hd, hu
	return H


def chain_log_derivative(atoms: int, H: np.ndarray, S: np.ndarray) -> float:
	"""``Σ_b tr(D log(B)[E_b] S_b)`` in float64: the directional derivative of ``Σ_p v_pᵀ log(A) v_p`` along
	``H`` for ``A`` block-diagonal with equal blocks ``B = tridiag(−1, 3, −1)`` of ``atoms`` rows. ``E_b`` are
	``H``'s blocks, ``S (chains, atoms, atoms)`` the probes' ``Σ_p v_b v_bᵀ``; ``D log(B)[E] = U (L ∘ UᵀEU) Uᵀ``
	on the shared eigenbasis, ``L`` the divided differences of log."""
	B = 3.0 * np.eye(atoms) - np.eye(atoms, k=1) - np.eye(atoms, k=-1)
	lam, U = np.linalg.eigh(B)
	same = np.eye(atoms, dtype=bool)
	L = np.where(same, 1.0 / lam[:, None], (np.log(lam)[:, None] - np.log(lam)[None, :]) / np.where(same, 1.0, lam[:, None] - lam[None, :]))
	chains = S.shape[0]
	hd, hu = H[1].reshape(chains, atoms), H[2].reshape(chains, atoms)[:, :-1]
	E = np.zeros((chains, atoms, atoms))
	i = np.arange(atoms)
	E[:, i, i] = hd
	E[:, i[:-1], i[1:]] = hu
	E[:, i[1:], i[:-1]] = hu
	D = U @ (L * (U.T @ E @ U)) @ U.T
	return float(np.sum(D * S))


def chain_probe_gram(V: np.ndarray, atoms: int) -> np.ndarray:
	"""``S (chains, atoms, atoms)``, each chain's ``Σ_p v_b v_bᵀ`` of the probes ``V (n, p)``."""
	Vb = V.reshape(-1, atoms, V.shape[1])
	return Vb @ Vb.transpose(0, 2, 1)


# -- edge shapes and refusals -----------------------------------------------------------------------


def _cpu(x) -> torch.Tensor:
	return torch.as_tensor(x).detach().to("cpu", torch.float64)


def _refuses(fn, exc=ValueError) -> bool:
	try:
		fn()
	except exc:
		return True
	return False


def _check(ok: bool, **row) -> dict:
	assert ok, row
	return row


def lanczos_deg_one(dev) -> dict:
	a, b = ptt.lanczos(ptt.symmetric(8, pd=True, seed=0, device=dev), deg=1)
	return _check(tuple(a.shape) == (1,) and tuple(b.shape) == (0,) and a.device.type == torch.device(dev).type)


def lanczos_deg_clamped_to_n(dev) -> dict:
	A = ptt.symmetric(6, pd=True, seed=1, dtype=torch.float64, device=dev)
	a, b = ptt.lanczos(A, deg=100, orth=-1)  # deg clamps to n
	err = float((torch.sort(_cpu(ptt.eigvalsh_tridiag(a, b))).values - torch.linalg.eigvalsh(_cpu(A))).abs().max()) if a.shape == (6,) else float("inf")
	return _check(err <= 1e-8, err=err)


def lanczos_rejects_bad_v0(dev) -> dict:
	return _check(_refuses(lambda: ptt.lanczos(ptt.symmetric(8, seed=2, device=dev), v0=np.ones(5))))


def hutch_single_probe_batch(dev) -> dict:
	est = float(ptt.hutch(ptt.symmetric(16, pd=True, seed=3, device=dev), batch=1, converge="count", count=64, seed=4))
	return _check(np.isfinite(est), estimate=est)


def hutch_tiny_matrix(dev) -> dict:
	est = float(ptt.hutch(torch.tensor([[2.0]], device=dev), converge="count", count=16, seed=5))
	return _check(abs(est - 2.0) < 1e-6, estimate=est)  # 1x1: every quadratic form is exact


def xtrace_batch_larger_than_n(dev) -> dict:
	A = ptt.symmetric(10, pd=True, seed=6, dtype=torch.float64, device=dev)
	est = float(ptt.xtrace(A, batch=64, seed=7))  # clamps to n columns
	return _check(abs(est - float(torch.trace(A))) < 1e-6, estimate=est)


def diag_tiny(dev) -> dict:
	A = ptt.symmetric(4, pd=True, seed=8, device=dev)
	d = _cpu(ptt.diag(A, seed=9, converge="count", count=400))
	return _check(bool(((d - torch.diag(_cpu(A))).abs() <= 0.3).all()), diag=d.tolist())


def matrix_function_min_degree(dev) -> dict:
	A = ptt.symmetric(12, pd=True, seed=10, device=dev)
	v = torch.tensor(np.random.default_rng(0).normal(size=12), dtype=A.dtype, device=dev)
	out = ptt.MatrixFunction(A, fun="identity", deg=2, orth=-1, device=dev) @ v
	refused = _refuses(lambda: ptt.MatrixFunction(A, deg=1, device=dev))
	return _check(bool(torch.isfinite(out).all()) and refused, refused=refused)


def quadrature_single_node(dev) -> dict:
	nodes, weights = ptt.quadrature(torch.tensor([2.0], device=dev), torch.zeros(0, device=dev), deg=1)
	return _check(_cpu(nodes).tolist() == [2.0] and abs(float(weights[0]) - 1.0) < 1e-6)


def mean_estimator_empty(dev) -> dict:
	est = ptt.MeanEstimator(device=dev)
	return _check(est.n_samples == 0 and np.isnan(est.estimate))


def hutchpp_small_m(dev) -> dict:
	est = float(ptt.hutchpp(ptt.symmetric(30, pd=True, seed=11, device=dev), m=3, seed=12))
	return _check(np.isfinite(est), estimate=est)


def scipy_bridge_in_float32(dev) -> dict:
	"""A scipy ``LinearOperator`` advertising float64 works as a float32 operator (its applies cross to
	the host and back in the operator's dtype)."""
	n = 48
	op = ptt.aslinop(spla.aslinearoperator(sps.eye(n, format="csr") * 3.0), dtype="float32", device=dev)
	est = float(ptt.hutch(op, seed=1, converge="count", count=16))
	return _check(op.dtype == torch.float32 and abs(est - 3.0 * n) < 1e-3, estimate=est)


def block_lanczos_tiny_matrix_default_width(dev) -> dict:
	"""Default b=4 on a 3x3 operator clamps instead of crashing."""
	from primate_tpu_torch.block_krylov import block_jacobi_dense, block_lanczos

	out = block_lanczos(np.diag([1.0, 2.0, 3.0]), seed=0, device=dev)
	ew = np.sort(np.linalg.eigvalsh(_cpu(block_jacobi_dense(out.Ablocks, out.Bblocks)).numpy()))
	return _check(bool(np.allclose(ew, [1.0, 2.0, 3.0], atol=1e-8)), eigenvalues=ew.tolist())


def classify_pdf_uninspectable_callable_is_size(dev) -> dict:
	"""Samplers with no inspectable signature (C-implemented) classify as numpy-style ``size`` callables."""
	from primate_tpu_torch.random import classify_pdf

	return _check(classify_pdf(time.time) == "size" and classify_pdf(np.random.default_rng(0).standard_normal) == "size")


def clt_quantile_ladder_is_shared(dev) -> dict:
	"""ConfidenceCriterion and ConfidenceEstimator use one quantile construction."""
	from primate_tpu_torch.estimators import clt_quantiles

	z, t = clt_quantiles(0.95)
	crit, est = ptt.ConfidenceCriterion(confidence=0.95), ptt.ConfidenceEstimator(confidence=0.95, device=dev)
	return _check(bool(np.isclose(crit.z, z) and np.isclose(est._z, z)
		and np.allclose(np.asarray(crit.t_scores), np.asarray(t).astype(np.float32)) and np.allclose(np.asarray(est._t), t)))


def suggest_probes_pdf_reaches_pilot(dev) -> dict:
	"""``pdf=`` forwards to the pilot run. On A = c·I the Rademacher quad form is exact (variance 0, the
	pilot minimum), Gaussian probes are not."""
	A = torch.eye(64, dtype=torch.float64, device=dev) * 2.0
	nv_rad, info_rad = ptt.recipes.suggest_probes(A, eps=0.001, pilot=16, seed=3, full=True)
	nv_nrm, info_nrm = ptt.recipes.suggest_probes(A, eps=0.001, pdf="normal", pilot=16, seed=3, full=True)
	return _check(info_rad["variance"] < 1e-8 and nv_rad == 16 and info_nrm["variance"] > 1.0 and nv_nrm > 16,
		rademacher=nv_rad, normal=nv_nrm)


def tiny_dia(n: int):
	"""``(operator, dense float64 matrix)``: a DIA ``tridiag(−1, 3, −1)`` of ``n`` rows."""
	A = sps.diags([-np.ones(n - 1), 3.0 * np.ones(n), -np.ones(n - 1)], [-1, 0, 1]).todia()
	return A, torch.tensor(A.toarray(), dtype=torch.float64)


def tiny_dia_operator(n: int, dev) -> dict:
	"""A DIA ``tridiag(−1, 3, −1)`` of ``n`` rows: its apply, Hutchinson's diagonal (within the JAX suite's
	diag limit), XTrace at m = n and the Lanczos sweep (deg clamps to n, Ritz values exact) equal the dense
	matrix's."""
	A, D = tiny_dia(n)
	op = ptt.DIAOperator.from_scipy(A, dtype=torch.float64, device=dev)
	V = torch.tensor(np.random.default_rng(n).normal(size=(n, 4)), dtype=torch.float64, device=dev)
	app = float((_cpu(op.matmat(V)) - D @ _cpu(V)).abs().max())
	app_t = float((_cpu(op.matmat_t(V.T.contiguous())) - (D @ _cpu(V)).T).abs().max())
	xt = float(ptt.xtrace(op, batch=4, seed=1))
	dg = _cpu(ptt.diag(op, seed=2, converge="count", count=64))
	a, b = ptt.lanczos(op, deg=20, orth=0, seed=3)
	ritz_err = float((torch.sort(_cpu(ptt.eigvalsh_tridiag(a, b))).values - torch.linalg.eigvalsh(D)).abs().max()) if tuple(a.shape) == (n,) else float("inf")
	diag_err = float((dg - 3.0).abs().mean())
	return _check(app <= 1e-12 and app_t <= 1e-12 and abs(xt - 3.0 * n) < 1e-8 and diag_err < 0.7 and ritz_err <= 1e-8,
		apply_err=app, apply_t_err=app_t, xtrace=xt, diag_mean_abs_err=diag_err, ritz_err=ritz_err)


EDGE_CASES = {
	f.__name__: f
	for f in (
		lanczos_deg_one, lanczos_deg_clamped_to_n, lanczos_rejects_bad_v0, hutch_single_probe_batch, hutch_tiny_matrix,
		xtrace_batch_larger_than_n, diag_tiny, matrix_function_min_degree, quadrature_single_node, mean_estimator_empty,
		hutchpp_small_m, scipy_bridge_in_float32, block_lanczos_tiny_matrix_default_width,
		classify_pdf_uninspectable_callable_is_size, clt_quantile_ladder_is_shared, suggest_probes_pdf_reaches_pilot,
	)
}
EDGE_CASES.update({f"tiny_dia_operator_{n}": functools.partial(tiny_dia_operator, n) for n in (1, 3)})
