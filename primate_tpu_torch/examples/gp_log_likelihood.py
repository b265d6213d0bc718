"""Gaussian-process log-marginal likelihood with gradients, end to end (``examples/gp_log_likelihood.py``).

    -2·log p(y|θ) = logdet K(θ) + yᵀ K(θ)⁻¹ y + n·log 2π

logdet comes from stochastic Lanczos quadrature (:func:`~primate_tpu_torch.autodiff.logdet`: SLQ
forward, ``tr(K⁻¹ ∂K)`` by batched CG on the same probes backward), the quadratic term from
Nyström-preconditioned CG through the differentiable solve, and the loss goes to ``torch.optim.Adam``
with fresh probes each step. Checks: the exact loss falls, the final SLQ logdet is within ``rtol`` of
the exact one and ``yᵀK⁻¹y`` within 1e-3 (float64 ``slogdet`` and ``solve`` of the dense kernel).

Run: python -m primate_tpu_torch.examples.gp_log_likelihood
"""

import math

import numpy as np
import torch

import primate_tpu_torch as ptt


def make_kernel(theta: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
	"""RBF kernel matrix + noise: θ = (log lengthscale, log noise)."""
	ell, noise = torch.exp(theta[0]), torch.exp(theta[1])
	sq = torch.sum((X[:, None, :] - X[None, :, :]) ** 2, dim=-1)
	return torch.exp(-0.5 * sq / ell**2) + (noise + 1e-4) * torch.eye(X.shape[0], dtype=X.dtype, device=X.device)


def _terms(theta, X, y, seed, deg: int = 24, nv: int = 32):
	"""``(logdet K, yᵀ K⁻¹ y)``, each differentiable in θ."""
	K = make_kernel(theta, X)
	logdet = ptt.autodiff.logdet(K, deg=deg, orth=8, nv=nv, seed=seed, solver_rtol=1e-6)
	# The preconditioner is solve machinery, built on K without its gradient.
	pre = ptt.nystrom_precond(K.detach(), rank=48, seed=0, device=K.device)
	return logdet, y @ ptt.solve(K, y, rtol=1e-8, precond=pre)


def neg_log_likelihood(theta, X, y, seed, deg: int = 24, nv: int = 32):
	logdet, quad = _terms(theta, X, y, seed, deg, nv)
	return 0.5 * (logdet + quad + X.shape[0] * math.log(2 * math.pi))


def exact_terms(theta, X, y) -> tuple:
	"""``(logdet K, yᵀ K⁻¹ y)`` by float64 ``slogdet`` and ``solve`` of the dense kernel."""
	K = make_kernel(theta.detach().double(), X.double())
	y64 = y.double()
	return float(torch.linalg.slogdet(K)[1]), float(y64 @ torch.linalg.solve(K, y64))


def main(device=None, n: int = 256, iters: int = 30, rtol: float = 0.05) -> dict:
	dev = torch.device(device or "cuda")
	d = 2
	rng = np.random.default_rng(0)
	Xn = rng.uniform(-2, 2, (n, d))
	X = torch.tensor(Xn, dtype=torch.float32, device=dev)
	y = torch.tensor(np.sin(Xn.sum(axis=1)) + 0.1 * rng.normal(size=n), dtype=torch.float32, device=dev)
	theta = torch.zeros(2, device=dev, requires_grad=True)
	opt = torch.optim.Adam([theta], lr=0.1)
	history = []
	for it in range(iters):
		opt.zero_grad()
		nll = neg_log_likelihood(theta, X, y, seed=1000 + it)
		nll.backward()
		opt.step()
		history.append(float(nll.detach()))
		if it % 5 == 0:
			print(f"iter {it:2d}  nll={float(nll):9.3f}  theta={np.round(theta.detach().cpu().numpy(), 3)}")
	with torch.no_grad():
		logdet, quad = (float(t) for t in _terms(theta, X, y, seed=1))
	const = n * math.log(2 * math.pi)
	ex_logdet, ex_quad = exact_terms(theta, X, y)
	final, exact = 0.5 * (logdet + quad + const), 0.5 * (ex_logdet + ex_quad + const)
	exact0 = 0.5 * (sum(exact_terms(torch.zeros(2), X, y)) + const)
	print(f"final stochastic nll={final:.3f}  exact={exact:.3f}")
	rel_logdet, rel_quad = abs(logdet - ex_logdet) / abs(ex_logdet), abs(quad - ex_quad) / abs(ex_quad)
	assert exact < exact0, f"the fit did not lower the exact loss: {exact} >= {exact0}"
	assert rel_logdet <= rtol, f"SLQ logdet {logdet} is {rel_logdet:.3g} from the exact {ex_logdet}"
	assert rel_quad <= 1e-3, f"yᵀK⁻¹y {quad} is {rel_quad:.3g} from the exact {ex_quad}"
	return {"n": n, "iters": iters, "history": history, "final": final, "exact": exact, "exact_at_start": exact0,
		"logdet": logdet, "exact_logdet": ex_logdet, "rel_err_logdet": rel_logdet, "quad": quad, "exact_quad": ex_quad,
		"rel_err_quad": rel_quad, "theta": theta.detach().cpu().tolist()}


if __name__ == "__main__":
	main()
