"""Spectrum slicing on a grid Laplacian whose eigenvalues are known (``examples/spectrum_slicing.py``).

The 5-point Dirichlet Laplacian of an nx × ny grid as a DIA operator: the Gershgorin enclosure,
the eigenvalue count of an interior window, every eigenpair in it by ``filtered_eigsh``, and
``Σ exp(−λ)`` over the slice two ways (the pairs found, and a stochastic windowed trace). Checks, as
the JAX script's: as many pairs as the closed form has in the window, each within 1e-3; besides,
the count within 15% of the closed form. The windowed trace is printed beside its value on the
closed-form spectrum.

Run: python -m primate_tpu_torch.examples.spectrum_slicing
"""

import numpy as np
import scipy.sparse as sps
import torch

import primate_tpu_torch as ptt
from primate_tpu_torch import DIAOperator
from primate_tpu_torch.operators.prepare import gershgorin_interval
from primate_tpu_torch.special import smoothstep


def grid_laplacian(nx: int, ny: int) -> sps.csr_matrix:
	"""5-point Laplacian of an nx × ny grid (Dirichlet); λ_{jk} = 4 sin²(jπ/2(nx+1)) + 4 sin²(kπ/2(ny+1))."""
	Tx = sps.diags([-np.ones(nx - 1), 2 * np.ones(nx), -np.ones(nx - 1)], [-1, 0, 1])
	Ty = sps.diags([-np.ones(ny - 1), 2 * np.ones(ny), -np.ones(ny - 1)], [-1, 0, 1])
	return (sps.kron(sps.identity(ny), Tx) + sps.kron(Ty, sps.identity(nx))).tocsr()


def grid_eigenvalues(nx: int, ny: int) -> np.ndarray:
	lx = 4 * np.sin(np.arange(1, nx + 1) * np.pi / (2 * (nx + 1))) ** 2
	ly = 4 * np.sin(np.arange(1, ny + 1) * np.pi / (2 * (ny + 1))) ** 2
	return np.sort((lx[:, None] + ly[None, :]).ravel())


def _window_exp(window):
	"""exp(−x) masked to the window by smoothsteps (for the stochastic check)."""
	a, b = window
	wdt = 0.02 * (b - a)
	rise, fall = smoothstep(a=a - wdt, b=a + wdt), smoothstep(a=b - wdt, b=b + wdt)
	return lambda x: torch.exp(-x) * (rise(x) - fall(x))


def main(device=None, nx: int = 40, ny: int = 25, window=(3.0, 3.3)) -> dict:
	dev = torch.device(device or "cuda")
	A = grid_laplacian(nx, ny)
	op = DIAOperator.from_scipy(A, dtype=torch.float32, device=dev)  # banded after kron ordering: stencil applies
	lam = grid_eigenvalues(nx, ny)

	lo, hi = gershgorin_interval(op)
	print(f"Gershgorin enclosure: [{lo:.3f}, {hi:.3f}] (true range [{lam[0]:.3f}, {lam[-1]:.3f}])")
	true_inside = lam[(lam >= window[0]) & (lam <= window[1])]
	count = ptt.recipes.eigencount(op, window, deg=40, converge="count", count=256, seed=0)
	print(f"eigencount{window}: {count} (true {len(true_inside)})")

	w, V = ptt.filtered_eigsh(op, window, k=count, spectral_interval=(lo, hi), seed=1)
	w64, V64 = w.double().cpu().numpy(), V.double().cpu().numpy()
	resid = np.linalg.norm(A @ V64 - V64 * w64[None, :], axis=0) if len(w64) else np.zeros(0)
	print(f"filtered_eigsh: {len(w64)} eigenpairs, max residual {resid.max() if len(w64) else 0:.2e}")
	err = float(np.abs(np.sort(w64) - true_inside).max()) if len(w64) == len(true_inside) else float("inf")
	print(f"eigenvalue error vs closed form: {err:.2e}")

	direct = float(np.sum(np.exp(-w64)))
	windowed = float(ptt.recipes.weighted_trace(
		op, torch.ones(op.shape[0], device=dev), fun=_window_exp(window), deg=60, orth=-1, converge="count", count=512, seed=2,
	))
	print(f"slice heat mass: direct Σexp(−λ) = {direct:.4f}, stochastic windowed trace ≈ {windowed:.4f}")

	assert lo <= lam[0] and hi >= lam[-1], (lo, hi)
	assert len(w64) == len(true_inside) and err < 1e-3, "slice mismatch"  # float32 on the card
	assert abs(count - len(true_inside)) <= 0.15 * len(true_inside), (count, len(true_inside))
	exact_windowed = float(torch.sum(_window_exp(window)(torch.from_numpy(lam))))
	print(f"the windowed trace on the closed-form spectrum: {exact_windowed:.4f} (the window's edges are sharper "
		"than a degree-60 quadrature resolves: printed, not checked, as in the JAX script)")
	print("OK")
	return {"n": nx * ny, "window": list(window), "gershgorin": [lo, hi], "eigencount": count, "closed_form_count": len(true_inside),
		"found": len(w64), "max_err": err, "max_residual": float(resid.max()) if len(w64) else 0.0, "direct": direct, "windowed": windowed,
		"exact_windowed": exact_windowed}


if __name__ == "__main__":
	main()
