"""Convergence and spectral-density figures (matplotlib).

Counterpart of ``primate_tpu/plotting.py``: the same seven functions and figures. The numbers
behind each figure are numpy helpers that need no matplotlib: the recorded samples of an
estimator (:func:`_sample_values`), the running mean and its standard error
(:func:`_running_mean_stderr`), the Jacobi polynomial curves, the orthonormal polynomials of
a Jacobi matrix through the port's own :func:`~primate_tpu_torch.fttr.ortho_poly` and
:func:`~primate_tpu_torch.tridiag.eigvalsh_tridiag`, a spectral function through
:func:`~primate_tpu_torch.special.param_callable`, and the error curves. The figure functions
import matplotlib in their bodies and raise ``ImportError`` where it is not installed.
"""

from typing import Optional, Sequence, Union

import numpy as np
import torch

__all__ = [
	"add_confidence_band",
	"figure_csm",
	"figure_error",
	"figure_fun",
	"figure_jacobi",
	"figure_orth_poly",
	"figure_sequence",
]


def _pyplot():
	"""``matplotlib.pyplot``, or an ``ImportError`` that says what still works without it."""
	try:
		import matplotlib.pyplot as plt
	except ImportError as err:
		raise ImportError(
			"primate_tpu_torch.plotting draws its figures with matplotlib, which is not installed; "
			"the numbers behind them (_sample_values, _running_mean_stderr, _jacobi_curves, "
			"_orth_poly_curves, _fun_curve, _error_curve) need only numpy"
		) from err
	return plt


def _sample_values(estimator) -> np.ndarray:
	"""The recorded per-sample values of an estimator (``record=True``), or a sequence, as a flat array."""
	if hasattr(estimator, "values"):
		vals = estimator.values
		if vals is None:
			raise ValueError("Estimator does not have values attached! Did you pass 'record=True' to the estimation call?")
		return np.ravel(np.asarray(vals.detach().cpu() if isinstance(vals, torch.Tensor) else vals, dtype=float))
	return np.asarray(estimator, dtype=float).ravel()


def _running_mean_stderr(x: np.ndarray):
	"""Cumulative mean and ddof-1 standard error of the mean (0 at n = 1). The samples are
	centred by the overall mean before the cumulative second moment, so the variance keeps
	its digits when ``|mean| ≫ σ``."""
	idx = np.arange(1, len(x) + 1)
	n = idx.astype(float)
	avgs = np.cumsum(x) / idx
	c = x - (avgs[-1] if len(x) else 0.0)
	cum_c = np.cumsum(c)
	cum_c2 = np.cumsum(c**2)
	var = np.maximum(cum_c2 / n - (cum_c / n) ** 2, 0.0) * n / np.maximum(n - 1, 1)
	return avgs, np.sqrt(var / n)


def _jacobi_curves(deg: int, alpha: float, beta: float, dom: np.ndarray) -> np.ndarray:
	"""The first ``deg`` Jacobi polynomials ``P_d^{(α, β)}`` at ``dom``, ``(deg, len(dom))``."""
	import scipy.special as spc

	return np.stack([spc.eval_jacobi(d, alpha, beta, dom) for d in range(deg)]) if deg else np.zeros((0, len(dom)))


def _orth_poly_curves(alpha, beta, k: Optional[int] = None, domain=None, points: int = 1500):
	"""``(dom, P)``: the first ``k`` orthonormal polynomials of the Jacobi coefficients
	``alpha (n,)``, ``beta (n,)`` (leading slot, ``beta[0]`` unused) on ``points`` nodes of
	``domain`` (default: the Gauss nodes' span padded by 5% a side); ``P (points, k)``."""
	from .fttr import ortho_poly
	from .tridiag import eigvalsh_tridiag

	alpha = torch.as_tensor(np.asarray(alpha, float))
	beta = torch.as_tensor(np.asarray(beta, float))
	n = alpha.shape[0]
	k = min(n, 6) if k is None else k
	if k > n:
		raise ValueError(f"k={k} exceeds the {n} available Jacobi coefficients")
	if domain is None:
		nodes = eigvalsh_tridiag(alpha, beta[1:n]).numpy()
		lo, hi = nodes.min(), nodes.max()
		pad = 0.05 * (hi - lo + (hi == lo))
		domain = (lo - pad, hi + pad)
	dom = np.linspace(domain[0], domain[1], points)
	return dom, ortho_poly(torch.from_numpy(dom), 1.0, alpha, beta).numpy()[:, :k]


def _fun_curve(fun, bounds: tuple = (-1.0, 1.0), points: int = 250, **kwargs):
	"""``(dom, values, name)`` of a spectral function (a builtin name with its parameters, or a
	callable on tensors) over ``bounds``."""
	from .special import param_callable

	if not (isinstance(fun, str) or callable(fun)):
		raise TypeError("'fun' must be string or callable.")
	name = fun if isinstance(fun, str) else getattr(fun, "__name__", "fun")
	f = param_callable(fun, **kwargs) if isinstance(fun, str) else fun
	dom = np.linspace(bounds[0], bounds[1], points, endpoint=True)
	out = f(torch.from_numpy(dom))
	return dom, np.asarray(out.detach().cpu() if isinstance(out, torch.Tensor) else out, dtype=float), name


def _error_curve(estimator, mu: Optional[float] = None, absolute: bool = True):
	"""``(idx, error)``: the running mean's true error against ``mu``, or without it the CLT
	bound (a t score below 30 samples, a normal one above; inf below 3 samples)."""
	sample_vals = _sample_values(estimator)
	valid = ~np.isnan(sample_vals)
	idx = np.arange(1, int(np.sum(valid)) + 1)
	avgs = np.cumsum(sample_vals[valid]) / idx
	if mu is not None:
		return idx, (np.abs(mu - avgs) if absolute else np.abs((mu - avgs) / mu))
	import scipy.stats as st

	cum_mean, std_err = _running_mean_stderr(sample_vals[valid])
	score = np.where(idx < 30, st.t.ppf(0.975, df=np.maximum(idx - 1, 1)), st.norm.ppf(0.975))
	with np.errstate(divide="ignore", invalid="ignore"):
		rerr = np.where(cum_mean == 0, np.inf, np.abs(std_err / cum_mean))
	return idx, np.where(idx < 3, np.inf, score * std_err if absolute else rerr)


def figure_csm(values, ax=None, **kwargs):
	"""Cumulative spectral density: the step CDF of the eigenvalues with rug marks."""
	plt = _pyplot()
	values = np.sort(np.asarray(values.detach().cpu() if isinstance(values, torch.Tensor) else values).ravel())
	if values.size == 0:
		raise ValueError("figure_csm requires at least one value")
	if ax is None:
		_, ax = plt.subplots(figsize=kwargs.pop("figsize", (4.5, 3.2)))
	csm = np.searchsorted(values, values, side="right") / len(values)
	ax.fill_between(np.append(values, values[-1]), 0, np.append(csm, 1.0), step="post", alpha=0.15)
	ax.step(np.append(values, values[-1]), np.append(csm, 1.0), where="post", lw=1.2)
	ax.plot(values, np.zeros_like(values), "x", color="red", ms=5, label="Eigenvalues")
	ax.set_title("Cumulative spectral density")
	ax.set_xlabel("Spectrum")
	ax.set_ylabel(r"$\mathbf{1}(\lambda \leq x)$")
	ax.legend(loc="upper left", fontsize=8)
	return ax


def figure_jacobi(deg: int = 4, alpha: float = 0, beta: float = 0, ax=None):
	"""The first ``deg`` (at most 10) Jacobi polynomials on [-1, 1]."""
	plt = _pyplot()
	if deg > 10:
		raise ValueError("figure_jacobi draws at most 10 polynomials")
	if ax is None:
		_, ax = plt.subplots(figsize=(4.5, 3.6))
	dom = np.linspace(-1, 1, 1500)
	for d, curve in enumerate(_jacobi_curves(deg, alpha, beta, dom)):
		ax.plot(dom, curve, lw=1.5, label=f"d={d}")
	ax.set_title(rf"Jacobi polynomials ($\alpha$={alpha:.1f}, $\beta$={beta:.1f})")
	ax.legend(loc="lower right", fontsize=8)
	return ax


def figure_orth_poly(alpha, beta, k: Optional[int] = None, domain=None, ax=None):
	"""The first ``k`` orthonormal polynomials of Jacobi coefficients ``alpha``, ``beta``
	(leading slot: ``beta[i]`` couples p_{i-1} to p_i), by the three-term recurrence."""
	plt = _pyplot()
	dom, P = _orth_poly_curves(alpha, beta, k, domain)
	if ax is None:
		_, ax = plt.subplots(figsize=(4.5, 3.6))
	for d in range(P.shape[1]):
		ax.plot(dom, P[:, d], lw=1.5, label=f"d={d}")
	ax.set_title("Orthogonal polynomials (three-term recurrence)")
	ax.legend(loc="lower right", fontsize=8)
	return ax


def figure_fun(fun, bounds: tuple = (-1.0, 1.0), ax=None, **kwargs):
	"""A spectral function (builtin name, its parameters in ``kwargs``, or a callable) over ``bounds``."""
	plt = _pyplot()
	dom, out, name = _fun_curve(fun, bounds, **kwargs)
	if ax is None:
		_, ax = plt.subplots(figsize=(3.2, 3.2))
	ax.plot(dom, out, lw=1.5)
	ax.set_title(f"fun = {name}")
	ax.set_xlabel(r"$\lambda$")
	return ax


def add_confidence_band(ax, estimator: Union[object, Sequence], confidence: float = 0.95, **kwargs):
	"""Shade the running CLT confidence band around the cumulative mean on ``ax``."""
	import scipy.special as spc

	sample_vals = _sample_values(estimator)
	x = sample_vals[~np.isnan(sample_vals)]
	idx = np.arange(1, len(x) + 1)
	avgs, std_err = _running_mean_stderr(x)
	moe = np.sqrt(2.0) * spc.erfinv(confidence) * std_err
	ax.fill_between(
		idx, avgs - moe, avgs + moe, alpha=kwargs.pop("alpha", 0.3), color=kwargs.pop("color", "yellow"),
		edgecolor=kwargs.pop("edgecolor", "black"), **kwargs,
	)
	return ax


def figure_sequence(estimator: Union[object, Sequence], mu: Optional[float] = None, ax=None, **kwargs):
	"""Per-sample variates and their running mean, with an optional true-value line."""
	plt = _pyplot()
	sample_vals = _sample_values(estimator)
	valid = ~np.isnan(sample_vals)
	idx = np.arange(1, int(np.sum(valid)) + 1)
	avgs = np.cumsum(sample_vals[valid]) / idx
	if ax is None:
		_, ax = plt.subplots(figsize=kwargs.pop("figsize", (5, 3.6)))
	ax.scatter(idx, sample_vals[valid], s=8, color="gray", label="samples")
	if mu is not None:
		ax.axhline(mu, color="red", lw=1.0)
	ax.plot(idx, avgs, color="black", lw=1.5, label="estimator")
	ax.set_title("Monte Carlo sample variates")
	ax.set_xlabel("Sample index")
	ax.set_ylabel("Estimates")
	ax.legend(loc="upper left", fontsize=8)
	return ax


def figure_error(
	estimator: Union[object, Sequence],
	mu: Optional[float] = None,
	threshold: Optional[float] = None,
	absolute: bool = True,
	title: str = "Estimator accuracy",
	ax=None,
	**kwargs,
):
	"""Error of the running mean against the sample count: the true error (``mu`` given) or
	the CLT confidence-interval bound."""
	plt = _pyplot()
	idx, cum_error = _error_curve(estimator, mu, absolute)
	if ax is None:
		_, ax = plt.subplots(figsize=kwargs.pop("figsize", (5, 3.6)))
	ax.plot(idx, cum_error, color="black", lw=1.2)
	if threshold is not None:
		ax.axhline(threshold, color="darkgray", ls="--", lw=1.0)
	ax.set_title(title)
	ax.set_xlabel("Sample index")
	ax.set_ylabel(("Abs. error" if absolute else "Rel. error") + (" (true)" if mu is not None else " (CI bound)"))
	ax.set_xlim(0, len(idx))
	return ax
