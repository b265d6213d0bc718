"""Tight-binding densities of states on the Hofstadter model (``examples/tight_binding.py``).

The square-lattice Hofstadter Hamiltonian (flux α per plaquette, Landau gauge, periodic) as a
complex CSR operator: the density of states by KPM (phase probes) and by SLQ, the partition
function ``Z(β) = tr e^{−βH}`` over a β sweep from one Lanczos sweep, the local density of states
at E = 0 through a Chebyshev expansion of a Gaussian window, and phase against Rademacher probes
on ``tr e^{−H}``. Checks against a dense float64 eigendecomposition of H: the KPM density's mass
within 1e-2 and below 20% of its peak at the centres of the four widest gaps (α = 1/5 gives five
bands), ``Z(β)`` within 5%, the LDOS mean within 10% of the
window's exact trace per site, and both probe kinds' means within 5 standard errors of the exact
``tr e^{−H}``.

Run: python -m primate_tpu_torch.examples.tight_binding
"""

import numpy as np
import scipy.sparse as sps
import torch

import primate_tpu_torch as ptt
from primate_tpu_torch import CSROperator


def hofstadter_hamiltonian(nx: int, ny: int, alpha: float = 1.0 / 5.0) -> sps.csr_matrix:
	"""Square-lattice Hofstadter Hamiltonian with flux ``alpha`` per plaquette (periodic): x-hops −1,
	y-hops ``−e^{2πiαx}`` and their conjugates, site ``i = x·ny + y``; scipy CSR, complex128,
	Hermitian by construction (the JAX example's construction, vectorised)."""
	n = nx * ny
	x, y = np.repeat(np.arange(nx), ny), np.tile(np.arange(ny), nx)
	i, jx, jy = x * ny + y, (x + 1) % nx * ny + y, x * ny + (y + 1) % ny
	t = -np.exp(2j * np.pi * alpha * x)
	rows, cols = np.concatenate([i, jx, i, jy]), np.concatenate([jx, i, jy, i])
	vals = np.concatenate([-np.ones(2 * n), t, np.conj(t)])
	return sps.csr_matrix((vals, (rows, cols)), shape=(n, n), dtype=np.complex128)


def main(device=None, nx: int = 40, ny: int = 40, alpha: float = 1.0 / 5.0) -> dict:
	dev = torch.device(device or "cuda")
	H = hofstadter_hamiltonian(nx, ny, alpha)
	op = CSROperator.from_scipy(H, dtype=torch.complex64, device=dev)
	n = op.shape[0]
	ew = np.linalg.eigvalsh(H.toarray())
	print(f"Hofstadter lattice {nx}x{ny} (n={n}, nnz={H.nnz}, flux α={alpha})")

	# Density of states: the α = 1/5 spectrum splits into 5 Hofstadter bands.
	ts, dos_kpm = ptt.kpm_density(op, m=256, nv=32, pdf="phase", seed=0)
	ts2, dos_slq = ptt.spectral_density(op, deg=64, nv=16, seed=1)
	ts, dos_kpm, ts2, dos_slq = (np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a, float) for a in (ts, dos_kpm, ts2, dos_slq))
	in_gap = dos_kpm < 0.2 * dos_kpm.max()
	print(f"KPM DOS: {int(np.sum(np.diff(in_gap.astype(int)) == 1))} gap entries; "
		f"SLQ grid agrees on support [{ts2.min():.2f}, {ts2.max():.2f}]")

	# Partition function over a β sweep, one Lanczos sweep for all β.
	betas = np.array([0.25, 0.5, 1.0, 2.0])
	Z = np.asarray(ptt.recipes.heat_kernel_trace(op, t=betas, deg=48, seed=2, converge="count", count=64))
	print("Z(β) = tr e^{−βH}:", np.array2string(Z, precision=1))

	# Local density of states at E = 0: a Gaussian window δ_σ(E − H) entrywise, unit-phase probes.
	sigma = 0.1
	window = ptt.ChebyshevFunction(
		op, fun=lambda x: torch.exp(-(x**2) / (2 * sigma**2)) / (sigma * np.sqrt(2 * np.pi)), deg=256
	)
	ldos = np.asarray(ptt.diag(window, pdf="phase", converge="count", count=192, seed=3))
	print(f"LDOS(E=0): mean {ldos.mean():.4f}, translation-flatness (std/mean) "
		f"{ldos.std() / max(ldos.mean(), 1e-12):.2f} (finite-probe noise; exact LDOS is x-periodic)")

	# Probe variance: phase against real Rademacher probes on tr(e^{−H}).
	ests = {pdf: [float(ptt.hutch(ptt.MatrixFunction(op, "exp", t=-1.0, deg=48), pdf=pdf, converge="count", count=32, seed=s))
		for s in range(8)] for pdf in ("phase", "rademacher")}
	print(f"tr e^(-H) — phase probes: {np.mean(ests['phase']):.1f} ± {np.std(ests['phase']):.2f}, "
		f"rademacher: {np.mean(ests['rademacher']):.1f} ± {np.std(ests['rademacher']):.2f}")

	exact = {
		"Z": [float(np.sum(np.exp(-b * ew))) for b in betas],
		"ldos_mean": float(np.mean(np.exp(-(ew**2) / (2 * sigma**2)) / (sigma * np.sqrt(2 * np.pi)))),
		"tr_exp": float(np.sum(np.exp(-ew))),
	}
	mass = float(np.sum(dos_kpm) * (ts[1] - ts[0]))
	# The four widest gaps of the exact spectrum (α = 1/5: five bands) read low on the KPM curve.
	gaps = np.argsort(np.diff(ew))[-4:]
	gap_dos = np.interp(0.5 * (ew[gaps] + ew[gaps + 1]), ts, dos_kpm) / dos_kpm.max()
	z_err = float(np.max(np.abs(Z - exact["Z"]) / exact["Z"]))
	ldos_err = abs(ldos.mean() - exact["ldos_mean"]) / exact["ldos_mean"]
	z_scores = {pdf: abs(np.mean(v) - exact["tr_exp"]) / (np.std(v, ddof=1) / np.sqrt(len(v)) + 1e-12) for pdf, v in ests.items()}
	print(f"against the dense spectrum: DOS mass {mass:.4f}, Z {z_err:.2e}, LDOS mean {ldos_err:.2e}, tr e^(-H) z {z_scores}")
	assert abs(mass - 1.0) <= 1e-2 and np.all(gap_dos < 0.2), (mass, gap_dos)
	assert z_err <= 0.05 and ldos_err <= 0.1, (z_err, ldos_err)
	assert all(z <= 5.0 for z in z_scores.values()), z_scores
	return {"n": n, "nnz": int(H.nnz), "kpm_gap_dos": gap_dos.tolist(), "kpm_mass": mass, "Z": Z.tolist(), "ldos_mean": float(ldos.mean()),
		"tr_exp_phase": ests["phase"], "tr_exp_rademacher": ests["rademacher"], "exact": exact,
		"rel_err": {"Z": z_err, "ldos_mean": float(ldos_err)}, "z_scores": z_scores}


if __name__ == "__main__":
	main()
