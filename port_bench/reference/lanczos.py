"""Plain block Lanczos with an optional window of classical Gram-Schmidt, and its Gauss rule.

Each probe is its own three-term recurrence ``β_{j+1} q_{j+1} = A q_j − α_j q_j − β_j q_{j−1}``
with ``q_0 = v/‖v‖``; with ``orth > 0`` the residual is also projected ``passes`` times off the
``orth`` newest basis vectors (``q_j`` among them). The Gauss rule of the Jacobi matrix gives
``vᵀ f(A) v ≈ ‖v‖² Σ_k τ_k f(θ_k)``.
"""

import numpy as np
import torch


def _rdot(X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
	"""``Re Σ conj(X)·Y`` over the last axis."""
	return torch.real(torch.sum(X.conj() * Y, dim=-1)) if X.is_complex() else torch.sum(X * Y, dim=-1)


def lanczos(apply, V: torch.Tensor, deg: int, orth: int = 0, passes: int = 1, rnd=lambda x: x):
	"""``(alphas, betas, ‖v‖²)`` of the probe-major block ``V (nv, n)``, each ``(deg, nv)`` and
	``(nv,)``, as float64 numpy arrays."""
	nv = V.shape[0]
	norm_sq = _rdot(V, V)
	q = rnd(V / torch.sqrt(norm_sq)[:, None])
	q_prev = torch.zeros_like(q)
	beta = torch.zeros(nv, dtype=norm_sq.dtype, device=V.device)
	window, alphas, betas = [q], [], []
	for _ in range(deg):
		w = apply(q)
		w.sub_(beta[:, None] * q_prev)
		alpha = _rdot(q, w)
		w.sub_(alpha[:, None] * q)
		if orth > 0:
			Q = torch.stack(window[-orth:])
			for _ in range(max(1, passes)):
				proj = torch.sum(Q.conj() * w[None], dim=-1)
				w.sub_(torch.sum(Q * proj[:, :, None], dim=0))
		beta = torch.sqrt(_rdot(w, w))
		alphas.append(alpha)
		betas.append(beta)
		q_prev, q = q, rnd(w / beta[:, None])
		window = window[-orth:] + [q] if orth > 0 else []
	out = lambda xs: torch.stack(xs).double().cpu().numpy()  # noqa: E731
	return out(alphas), out(betas), norm_sq.double().cpu().numpy()


def gauss_rule(alphas: np.ndarray, betas: np.ndarray) -> tuple:
	"""Nodes and weights ``(nv, deg)`` of each probe's Jacobi matrix (Golub-Welsch), float64."""
	deg = alphas.shape[0]
	J = np.zeros((alphas.shape[1], deg, deg))
	k = np.arange(deg)
	J[:, k, k] = alphas.T
	J[:, k[:-1], k[1:]] = J[:, k[1:], k[:-1]] = betas[: deg - 1].T
	nodes, U = np.linalg.eigh(J)
	return nodes, U[:, 0, :] ** 2


def smoothed_density(nodes: np.ndarray, weights: np.ndarray, grid: int, deg: int) -> tuple:
	"""The Gaussian-broadened density of the probes' rules on ``grid`` points spanning the extreme
	nodes widened by 5%, broadening the span over ``max(deg, 8)``: ``(ts, phi)``, mass about 1."""
	lo, hi = float(nodes.min()), float(nodes.max())
	pad = 0.05 * max(hi - lo, 1e-12)
	ts = np.linspace(lo - pad, hi + pad, int(grid))
	sigma = (ts[-1] - ts[0]) / max(deg, 8)
	z = (ts[None, :] - nodes.reshape(-1)[:, None]) / sigma
	phi = (weights.reshape(-1) / nodes.shape[0]) @ (np.exp(-0.5 * z * z) / (sigma * np.sqrt(2.0 * np.pi)))
	return ts, phi
