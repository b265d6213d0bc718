"""The periodic Hofstadter Hamiltonian as eight bands: offsets ±1 and ±(ny−1) for the hops along
y (the second pair where they wrap), ±ny and ±(nx−1)·ny for the hops along x."""

import math

import torch


def bands(params: dict, dtype: torch.dtype, device) -> tuple:
	nx, ny, a, hop = int(params["nx"]), int(params["ny"]), float(params["alpha"]), float(params["hopping"])
	n = nx * ny
	r = torch.arange(n, device=device)
	x, y = r // ny, r % ny
	# −t·e^{2πiαx} by row, its angle in float64 before the cast, as the plain example computes it
	t = -torch.polar(torch.full((n,), hop, dtype=torch.float64, device=device), (2.0 * math.pi * a) * x.double()).to(dtype)
	zero = torch.zeros((), dtype=dtype, device=device)
	minus = torch.full((), -hop, dtype=dtype, device=device)
	rows = {
		-(nx - 1) * ny: torch.where(x == nx - 1, minus, zero),
		-ny: torch.where(x >= 1, minus, zero),
		-(ny - 1): torch.where(y == ny - 1, t, zero),
		-1: torch.where(y >= 1, t.conj(), zero),
		1: torch.where(y < ny - 1, t, zero),
		ny - 1: torch.where(y == 0, t.conj(), zero),
		ny: torch.where(x < nx - 1, minus, zero),
		(nx - 1) * ny: torch.where(x == 0, minus, zero),
	}
	offsets = tuple(sorted(rows))
	return torch.stack([rows[o] for o in offsets]).resolve_conj(), offsets, (n, n)
