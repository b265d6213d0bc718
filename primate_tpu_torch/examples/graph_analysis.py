"""Spectral graph analysis of a k-nearest-neighbour graph (``examples/graph_analysis.py``).

The graph Laplacian of random 2-D points as a CSR operator: an Estrada-type index
``tr exp(−L/2)``, the eigenvalue count in (0, 1], the heat-kernel signature at three times, one
entry of ``exp(−L/2)`` by the polarization identity, and the density of states by SLQ and by the
kernel polynomial method. Checks against a dense float64 eigendecomposition of L: the index and
the signature's mean within 3%, the count within 10%, the entry within 1e-4 (relative), and both
densities peaked inside the spectrum.

Run: python -m primate_tpu_torch.examples.graph_analysis
"""

import numpy as np
import scipy.sparse as sps
import torch

import primate_tpu_torch as ptt
from primate_tpu_torch import CSROperator


def build_graph_laplacian(n: int = 2000, k: int = 6, seed: int = 0) -> sps.csr_matrix:
	"""k-nearest-neighbour graph on random 2-D points (symmetrized)."""
	from scipy.spatial import cKDTree

	rng = np.random.default_rng(seed)
	pts = rng.uniform(size=(n, 2))
	_, idx = cKDTree(pts).query(pts, k=k + 1)
	rows = np.repeat(np.arange(n), k)
	W = sps.csr_matrix((np.ones(n * k), (rows, idx[:, 1:].ravel())), shape=(n, n))
	W = W.maximum(W.T)
	return (sps.diags(np.asarray(W.sum(axis=1)).ravel()) - W).tocsr()


def main(device=None, n: int = 2000) -> dict:
	dev = torch.device(device or "cuda")
	L = build_graph_laplacian(n)
	op = CSROperator.from_scipy(L, dtype=torch.float32, device=dev)
	ew, U = np.linalg.eigh(L.toarray())

	estrada = ptt.recipes.estrada_index(op, t=-0.5, deg=24, converge="count", count=128, seed=1)
	print(f"Estrada-type index tr(exp(-L/2)) ≈ {estrada:.1f}")
	n_small = ptt.recipes.eigencount(op, (-0.01, 1.0), deg=40, converge="count", count=256, seed=2)
	print(f"eigenvalues in (0, 1]: ≈ {n_small} of {n}")
	hks = np.asarray(ptt.recipes.heat_kernel_signature(op, [0.1, 1.0, 10.0], deg=24, converge="count", count=64, seed=3))
	print(f"heat-kernel signature: shape {hks.shape}, t=0.1 mean {hks[0].mean():.4f}")

	# Communicability between two nodes: one entry of exp(-L/2) from two quadratic forms.
	j = int(L[0].indices[L[0].indices != 0][0])  # a neighbour of node 0
	ei, ej = np.eye(n)[:, 0], np.eye(n)[:, j]
	comm = float(ptt.recipes.bilinear_form(op, ei, ej, fun="exp", fun_kwargs={"t": -0.5}, deg=24))
	print(f"communicability exp(-L/2)[0, {j}] ≈ {comm:.6f}")

	ts, phi = ptt.spectral_density(op, deg=64, nv=8, seed=4)
	ts2, phi2 = ptt.kpm.kpm_density(op, m=128, nv=8, seed=5)
	ts, phi, ts2, phi2 = (np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x) for x in (ts, phi, ts2, phi2))
	print(f"DOS (SLQ):  peak at λ≈{ts[np.argmax(phi)]:.2f}")
	print(f"DOS (KPM):  peak at λ≈{ts2[np.argmax(phi2)]:.2f}")

	exact = {
		"estrada": float(np.sum(np.exp(-0.5 * ew))),
		"count": int(np.sum((ew > -0.01) & (ew <= 1.0))),
		"hks_mean": [float(np.mean(np.exp(-t * ew))) for t in (0.1, 1.0, 10.0)],
		"comm": float((U[0] * np.exp(-0.5 * ew)) @ U[j]),
	}
	errs = {
		"estrada": abs(estrada - exact["estrada"]) / exact["estrada"],
		"count": abs(n_small - exact["count"]) / exact["count"],
		"hks_mean": float(max(abs(hks[i].mean() - exact["hks_mean"][i]) / exact["hks_mean"][i] for i in range(3))),
		"comm": abs(comm - exact["comm"]) / abs(exact["comm"]),
	}
	print(f"against the dense spectrum: {errs}")
	assert errs["estrada"] <= 0.03 and errs["hks_mean"] <= 0.1, errs
	assert errs["count"] <= 0.1 and errs["comm"] <= 1e-4, errs
	for grid, dens in ((ts, phi), (ts2, phi2)):
		assert np.all(np.isfinite(dens)) and ew[0] - 0.5 <= grid[np.argmax(dens)] <= ew[-1] + 0.5
	return {"n": n, "nnz": int(L.nnz), "estrada": estrada, "eigencount": int(n_small), "hks_mean": hks.mean(axis=1).tolist(),
		"communicability": comm, "slq_peak": float(ts[np.argmax(phi)]), "kpm_peak": float(ts2[np.argmax(phi2)]),
		"exact": exact, "rel_err": errs}


if __name__ == "__main__":
	main()
