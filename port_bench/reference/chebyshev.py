"""Plain Chebyshev moments and the Jackson-damped kernel polynomial density (Weiße et al.,
Rev. Mod. Phys. 78, 275 (2006), eqs. 71 and 81).

With ``Ã = (A − c)/r`` mapping the interval onto ``[−1, 1]``, ``μ_k = E_v Re v† T_k(Ã) v`` by the
recurrence ``T_{k+1} = 2Ã T_k − T_{k−1}``, and
``φ(t) = [g₀μ₀ + 2 Σ_{k≥1} g_k μ_k T_k(x)] / (π √(1 − x²) · n · r)`` with ``x = (t − c)/r``
clamped to ``cos(π/2m)``.
"""

import numpy as np
import torch

from .lanczos import _rdot


def moments(apply, V: torch.Tensor, m: int, c: float, r: float, rnd=lambda x: x) -> np.ndarray:
	"""``Σ_v Re v† T_k(Ã) v`` for ``k < m`` over the block's probes ``V (nv, n)``: float64 ``(m,)``."""
	out = [_rdot(V, V)]
	prev, cur = V, rnd((apply(V) - c * V) / r)
	out.append(_rdot(V, cur))
	for _ in range(2, m):
		prev, cur = cur, rnd((apply(cur) - c * cur).mul_(2.0 / r).sub_(prev))
		out.append(_rdot(V, cur))
	return torch.stack(out[:m]).double().sum(dim=1).cpu().numpy()


def jackson(m: int) -> np.ndarray:
	k = np.arange(m)
	M = m + 1.0
	return ((M - k) * np.cos(np.pi * k / M) + np.sin(np.pi * k / M) / np.tan(np.pi / M)) / M


def density(mus: np.ndarray, interval: tuple, grid: int, n: int) -> tuple:
	"""``(ts, phi)`` on ``grid`` points spanning ``interval`` from the probe-mean moments ``mus``."""
	m, (lo, hi) = len(mus), interval
	c, r = (hi + lo) / 2.0, (hi - lo) / 2.0
	ts = np.linspace(lo, hi, int(grid))
	xmax = np.cos(np.pi / (2 * m))
	x = np.clip((ts - c) / r, -xmax, xmax)
	g = jackson(m)
	Tkx = np.cos(np.arange(m)[:, None] * np.arccos(x)[None, :])
	series = g[0] * mus[0] + 2.0 * (g[1:, None] * mus[1:, None] * Tkx[1:]).sum(axis=0)
	return ts, series / (np.pi * np.sqrt(1.0 - x**2)) / (n * r)
