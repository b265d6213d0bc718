"""Spectral density (DOS) estimation by stochastic Lanczos quadrature.

Counterpart of ``primate_tpu/density.py`` (Lin, Saad & Yang, SIAM Review 2016,
§3.2): each probe's Lanczos quadrature rule (θ, τ) is an unbiased sample of the
spectral measure, and the Gaussian-broadened rules averaged over probes give the
smoothed density of states

	φ_σ(t) = (1/nv) Σ_v Σ_i τ_i^(v) · N(t; θ_i^(v), σ²),

evaluated on a grid as one product of the (nv·deg) weights with the broadened
nodes. Hermitian (complex) operators run the complex sweep. A ``GramOperator``'s
density (of the squared singular values) comes from Golub-Kahan bidiagonalisation
of its data operator (``primate_tpu/density.py:69-85``), as ``MatrixFunction.quad``'s does.
"""

from typing import Optional, Tuple, Union

import numpy as np
import torch

from .integrate import quadrature
from .lanczos import lanczos_block_op
from .linalg import full_f32_matmul
from .operators.base import aslinop
from .random import probe_dtype, sample_isotropic
from .trace import estimate_only
from .utils.profiling import annotate

__all__ = ["spectral_density", "cumulative_spectral_density", "spectral_quantile"]


def _gauss(t: torch.Tensor, mu: torch.Tensor, sigma: float) -> torch.Tensor:
	z = (t[None, :] - mu[:, None]) / sigma
	return torch.exp(-0.5 * z * z) / (sigma * float(np.sqrt(2.0 * np.pi)))


@estimate_only
def spectral_density(
	A,
	grid: Union[int, np.ndarray] = 256,
	deg: int = 64,
	nv: int = 16,
	sigma: Optional[float] = None,
	bounds: Optional[Tuple[float, float]] = None,
	pdf: str = "rademacher",
	orth: int = 0,
	seed=None,
) -> Tuple[np.ndarray, np.ndarray]:
	"""The smoothed spectral density of a symmetric or Hermitian ``A``
	(``primate_tpu/density.py:36-99``): ``(ts, phi)`` as numpy arrays, ``∫ phi dt ≈ 1``.

	``grid``: an int (points spanning ``bounds``) or the grid itself; ``deg``: Lanczos
	steps, the quadrature nodes per probe; ``nv``: probes (batch 0 of ``seed``);
	``sigma``: the broadening, by default the grid's span over ``max(deg, 8)``;
	``bounds``: by default the extreme Ritz values widened by 5%; ``pdf``, ``orth``:
	as in ``hutch`` and ``lanczos``.
	"""
	from .operators.sparse import GramOperator
	from .trace import _base_seed, batch_generator

	op = aslinop(A)
	n = op.shape[0]
	deg = int(min(deg, n))
	orth = deg if (orth < 0 or orth > deg) else int(orth)
	g = batch_generator(_base_seed(seed), 0, op.device)
	V = sample_isotropic(g, (n, int(nv)), pdf=pdf, dtype=probe_dtype(op.dtype, pdf)).to(op.dtype)
	if isinstance(op, GramOperator):
		from .bidiag import bidiag_jacobi, lanczos_bidiag_op

		bdeg = int(min(deg, min(op.A.shape)))
		bout = lanczos_bidiag_op(op.A, V, deg=bdeg, orth=min(orth, bdeg), adjoint=not op.transpose_first)
		d, e = bidiag_jacobi(bout.alphas, bout.betas)
		nodes, weights = quadrature(d.T, e.T, deg=bdeg, quad="gw")  # (nv, bdeg) each
		nodes = torch.clamp(nodes, min=0.0)  # BᵀB is PSD; eigh may give −ε
	else:
		out = lanczos_block_op(op, V, deg=deg, ncv=max(2, min(max(orth, 2), deg)), orth=orth, return_basis=False)
		nodes, weights = quadrature(out.alphas.T, out.betas[: deg - 1].T, deg=deg, quad="gw")  # (nv, deg) each
	with annotate("primate.quadrature"):
		if bounds is None:
			lo, hi = float(torch.min(nodes)), float(torch.max(nodes))
			pad = 0.05 * max(hi - lo, 1e-12)
			bounds = (lo - pad, hi + pad)
		if np.isscalar(grid):
			ts = torch.linspace(float(bounds[0]), float(bounds[1]), int(grid), dtype=nodes.dtype, device=nodes.device)
		else:
			ts = torch.as_tensor(np.asarray(grid), dtype=nodes.dtype, device=nodes.device)
		if sigma is None:
			sigma = float(ts[-1] - ts[0]) / max(deg, 8)
		with full_f32_matmul():
			phi = (weights.reshape(-1) / int(nv)) @ _gauss(ts, nodes.reshape(-1), sigma)
		return ts.cpu().numpy(), phi.cpu().numpy()


def cumulative_spectral_density(A, grid: Union[int, np.ndarray] = 256, **kwargs) -> Tuple[np.ndarray, np.ndarray]:
	"""The smoothed cumulative spectral measure ``Φ(t) = ∫_{-∞}^t φ`` on the grid
	(``primate_tpu/density.py:102-111``)."""
	ts, phi = spectral_density(A, grid=grid, **kwargs)
	dt = np.diff(ts, prepend=ts[0])
	return ts, np.cumsum(phi * dt)


def spectral_quantile(A, q, grid: Union[int, np.ndarray] = 512, **kwargs):
	"""Spectrum quantiles: the ``t`` with ``Φ(t) ≈ q`` of the normalised measure, ``q`` in [0, 1]
	(``primate_tpu/density.py:114-139``), by monotone interpolation of the cumulative density;
	a scalar ``q`` gives a float. Other keywords go to :func:`spectral_density`."""
	ts, csm = cumulative_spectral_density(A, grid=grid, **kwargs)
	total = float(csm[-1])
	if not (total > 0 and np.isfinite(total)):
		raise ValueError("Degenerate spectral measure (empty grid or NaN density)")
	cdf = np.asarray(csm) / total
	qs = np.atleast_1d(np.asarray(q, dtype=float))
	if not np.all((qs >= 0.0) & (qs <= 1.0)):
		raise ValueError("Quantiles must lie in [0, 1]")
	out = np.interp(qs, cdf, np.asarray(ts))
	return float(out[0]) if np.isscalar(q) or getattr(q, "ndim", 1) == 0 else out
