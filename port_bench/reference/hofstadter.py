"""The periodic square-lattice Hofstadter Hamiltonian (Landau gauge, flux ``α`` a plaquette).

Site ``i = x·ny + y``. Hops along x carry ``−t``; a hop from ``(x, y+1)`` to ``(x, y)`` carries
``−t·e^{2πiαx}`` and its reverse the conjugate; both directions wrap. With ``α·nx`` whole every
plaquette holds the flux ``α``, and the shortest closed walks give ``tr H² = 4t²n`` and
``tr H⁴ = (28 + 8 cos 2πα)·t⁴n``.
"""

import math

import numpy as np
import torch


def size(params: dict) -> int:
	return int(params["nx"]) * int(params["ny"])


def phases(params: dict, dtype: torch.dtype, device) -> torch.Tensor:
	"""``−t·e^{2πiαx}`` for ``x = 0..nx−1``, computed in float64 and then cast to ``dtype``."""
	x = torch.arange(int(params["nx"]), dtype=torch.float64, device=device)
	return -torch.polar(torch.full_like(x, float(params["hopping"])), 2.0 * math.pi * float(params["alpha"]) * x).to(dtype)


def apply(params: dict, X: torch.Tensor, rnd=lambda x: x) -> torch.Tensor:
	"""``H X`` on a probe-major ``(nv, n)`` block (real blocks are promoted to complex)."""
	nx, ny, t = int(params["nx"]), int(params["ny"]), float(params["hopping"])
	if not X.is_complex():
		X = X.to(torch.complex128 if X.dtype == torch.float64 else torch.complex64)
	Z = X.reshape(X.shape[0], nx, ny)
	ph = rnd(phases(params, X.dtype, X.device))[None, :, None]
	Y = (torch.roll(Z, -1, dims=1) + torch.roll(Z, 1, dims=1)).mul_(-t)
	Y.add_(ph * torch.roll(Z, -1, dims=2)).add_(ph.conj() * torch.roll(Z, 1, dims=2))
	return Y.reshape(X.shape)


def interval(params: dict) -> tuple:
	r = 4.0 * abs(float(params["hopping"]))
	return -r, r


def traces(params: dict) -> tuple:
	"""``(tr H², tr H⁴)`` from the closed walks of length 2 and 4."""
	n, t, a = size(params), float(params["hopping"]), float(params["alpha"])
	return 4.0 * t**2 * n, (28.0 + 8.0 * np.cos(2.0 * np.pi * a)) * t**4 * n
