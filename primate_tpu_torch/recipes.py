"""Spectral-sum recipes: the compositions the reference documents, as functions.

Counterpart of ``primate_tpu/recipes.py``. Each recipe composes the port's modules
(``hutch(MatrixFunction(A, f))``, ``diag``, ``eigsh``, ``cg``, the Lanczos sweep and the
quadrature rules) and takes the estimator knobs of :func:`~primate_tpu_torch.hutch`
(``batch``, ``converge``, ``seed``, ``pdf``, ``full``, ...). Every operator and tensor a
recipe builds lies on its operator's device (a numpy or scipy matrix goes to the card,
as :func:`~primate_tpu_torch.operators.aslinop` puts it).

Returns follow :func:`~primate_tpu_torch.hutch` and :func:`~primate_tpu_torch.diag`: a
scalar estimate is a Python float (an integer for ``numrank`` and ``eigencount``), an
estimate per function or per point a numpy array, each with an
:class:`~primate_tpu_torch.EstimatorResult` after it when ``full=True``;
``bilinear_form`` returns a numpy array; ``topk``, ``tikhonov`` and ``pagerank`` return
tensors (an operator and the eigenpairs, the solutions).

On DIA operators the recipes reach the CUDA kernels through the modules they compose:
an SLQ recipe at ``orth=0`` runs both Lanczos step kernels, at ``orth > 0`` (the default
5) pass A ``lanczos_dia_step`` and the re-orthogonalisation in PyTorch; ``trace_bounds``
and ``suggest_degree`` re-orthogonalise fully (``orth=-1``); the CG recipes
(``trace_inv(method="cg")``, ``tikhonov``, ``pagerank``) apply the probe-major stencil
``dia_stencil_t`` once an iteration through the operator pencils; the eigenspace recipes
(``deflated_trace``, ``condition_number``, ``topk``) run LOBPCG on the node-major
``dia_stencil``.
"""

from functools import lru_cache
from typing import Optional, Union

import numpy as np
import torch

from .linalg import full_f32_matmul
from .operators import MatrixFunction, aslinop
from .operators.base import LinearOperator
from .special import stacked
from .trace import estimate_only, hutch

__all__ = [
	"bilinear_form",
	"condition_number",
	"deflated_trace",
	"effective_dim",
	"logdet",
	"trace_bounds",
	"trace_inv",
	"estrada_index",
	"heat_kernel_trace",
	"heat_kernel_signature",
	"numrank",
	"eigencount",
	"pagerank",
	"schatten",
	"topk",
	"slogdet",
	"suggest_degree",
	"shifted_trace",
	"tikhonov",
	"suggest_probes",
	"weighted_trace",
]


@lru_cache(maxsize=64)
def _shift_family_cached(f, shifts: tuple):
	return stacked(lambda x, t: f(x + t), np.asarray(shifts))


def _shift_family(f, shifts: tuple):
	"""``stacked(x ↦ f(x + t), shifts)``, memoised on ``(f, shifts)`` so that a repeated
	``shifted_trace`` keeps one family. An unhashable ``f`` skips the memo."""
	try:
		return _shift_family_cached(f, shifts)
	except TypeError:  # the lookup of an unhashable f, before anything runs
		return stacked(lambda x, t: f(x + t), np.asarray(shifts))


@lru_cache(maxsize=256)
def _memo_fun(kind: str, *params: float):
	"""The parameterised spectral functions of the recipes, memoised on ``(kind, params)``
	so that repeated calls hand ``MatrixFunction`` the same callable."""
	if kind == "window":  # eigencount's difference of smoothsteps
		from .special import smoothstep

		a, b, w = params
		rise = smoothstep(a=a - w / 2, b=a + w / 2)
		fall = smoothstep(a=b - w / 2, b=b + w / 2)
		return lambda x: rise(x) - fall(x)
	if kind == "logabs":  # slogdet's log|x|, floored
		return lambda x: torch.log(torch.clamp(torch.abs(x), min=1e-30))
	if kind == "effdim":  # x/(x+λ)
		(lam,) = params
		return lambda x: x / (x + lam)
	if kind == "effdim_fam":
		return stacked(lambda x, v: x / (x + v), np.asarray(params))
	if kind == "abspow":  # |x|^p (Schatten)
		(q,) = params
		return lambda x: torch.abs(x) ** q
	if kind == "abspow_fam":
		return stacked(lambda x, q: torch.abs(x) ** q, np.asarray(params))
	if kind == "grampow":  # max(x, 0)^(p/2) (Schatten through the Gram operator)
		(q,) = params
		return lambda x: torch.clamp(x, min=0.0) ** (q / 2.0)
	if kind == "grampow_fam":
		return stacked(lambda x, q: torch.clamp(x, min=0.0) ** (q / 2.0), np.asarray(params))
	raise KeyError(kind)


@estimate_only
def _slq(A, fun, deg: int, orth: int, fun_kwargs: Optional[dict] = None, **est_kwargs):
	M = MatrixFunction(A, fun=fun, deg=deg, orth=orth, **(fun_kwargs or {}))
	return hutch(M, **est_kwargs)


@estimate_only
def deflated_trace(
	A,
	fun: Union[str, callable, None] = None,
	k: int = 8,
	which: str = "LM",
	deg: int = 20,
	orth: int = 5,
	fill: Optional[float] = None,
	fun_kwargs: Optional[dict] = None,
	eigsh_kwargs: Optional[dict] = None,
	**est_kwargs,
):
	"""Variance-reduced ``tr(f(A))``: an exact top-``k`` eigenspace and a stochastic rest.

	The ``k`` extremal eigenpairs come from :func:`~primate_tpu_torch.eigsh` (seeded by
	``seed``, with ``eigsh_kwargs``); ``Σ f(λᵢ)`` is taken exactly and the rest estimated on
	the deflated operator ``P A P + fill·VVᴴ``:

	    tr(f(A)) = Σᵢ f(λᵢ) + tr(f(P A P + fill·VVᴴ)) − k·f(fill).

	For ``fun=None`` the identity is exact for any orthonormal ``V``; for a nonlinear ``f``
	the bias is second order in the eigensolver's residual. ``fill`` defaults to 1 for log
	and inv (where ``f(0)`` is singular), else 0.
	"""
	from .eigen import eigsh
	from .operators import DeflatedOperator
	from .random import real_dtype
	from .special import param_callable

	op = aslinop(A)
	w, V = eigsh(op, k=k, which=which, seed=est_kwargs.get("seed"), **(eigsh_kwargs or {}))
	if fill is None:
		fill = 1.0 if fun in ("log", "inv") else 0.0
	f = param_callable(fun, **(fun_kwargs or {})) if isinstance(fun, str) else fun

	defl = DeflatedOperator(op, V, fill=fill)
	# Correct by the deflated count: eigsh can return fewer than k pairs (a degenerate
	# pair found from both ends), and each filled direction adds f(fill).
	k_act = int(V.shape[1])
	if fun is None:
		exact = float(torch.sum(w))
		correction = -float(k_act) * float(fill)
		rest = hutch(defl, **est_kwargs)
	else:
		exact = float(torch.real(torch.sum(f(w))))
		correction = -float(k_act) * float(f(torch.tensor(fill, dtype=real_dtype(defl.dtype), device=op.device)))
		rest = _slq(defl, fun, deg, orth, fun_kwargs=fun_kwargs, **est_kwargs)
	if isinstance(rest, tuple):
		est, result = rest
		result.estimate = exact + est + correction
		result.info["deflated_eigenvalues"] = w.cpu().numpy()
		return result.estimate, result
	return exact + rest + correction


def logdet(A, deg: int = 20, orth: int = 5, **kwargs):
	"""``log det(A) = tr(log A)`` of a symmetric positive-definite ``A`` by stochastic Lanczos quadrature."""
	return _slq(A, "log", deg, orth, **kwargs)


def slogdet(A, deg: int = 30, orth: int = 5, count_deg: int = 30, **kwargs):
	"""``(sign, log|det A|)`` of a symmetric indefinite operator, as ``numpy.linalg.slogdet``.

	``log|det| = tr(log|A|)`` by Lanczos quadrature of ``log∘abs``, and ``sign =
	(−1)^{#negative eigenvalues}`` with the negative count from :func:`eigencount` over
	``[λ_min, 0)``, rounded. The count runs only when the smallest Ritz value of a fully
	re-orthogonalised 32-step sweep (seeded by ``seed``) is negative, which certifies
	indefiniteness; the same sweep gives the count's lower end. The sign is reliable when
	the count's error is below 0.5: raise the probes near singular spectra. For
	positive-definite operators :func:`logdet` is cheaper.
	"""
	from .lanczos import rayleigh_ritz

	op = aslinop(A)
	rw = rayleigh_ritz(op, deg=int(min(32, op.shape[0])), orth=-1, seed=kwargs.get("seed"))
	rw_min, rw_max = float(torch.min(rw)), float(torch.max(rw))
	n_neg = 0
	if rw_min < 0:
		pad = 0.03 * max(rw_max - rw_min, 1e-12) + 1e-12
		n_neg = int(eigencount(op, (rw_min - pad, 0.0), deg=count_deg, **{k: v for k, v in kwargs.items() if k != "full"}))
	sign = -1.0 if (n_neg % 2) else 1.0
	est = _slq(op, _memo_fun("logabs"), deg, orth, **kwargs)
	if isinstance(est, tuple):
		val, result = est
		result.info["sign"] = sign
		result.info["n_negative"] = n_neg
		return (sign, float(val)), result
	return sign, float(est)


# Derivative-sign classes for Golub-Meurant bracketing (see trace_bounds): which
# modified rules bound from below and which from above.
_BOUND_CLASSES = {
	# f^(2n) < 0, f^(2n+1) > 0 on (0, ∞): log, sqrt, x^p with 0 < p < 1
	"bernstein": {"lower": ("radau_lo", "lobatto"), "upper": ("gauss", "radau_hi")},
	# f^(2n) > 0, f^(2n+1) < 0: inv, exp(−t·x) with t > 0
	"completely_monotone": {"lower": ("gauss", "radau_hi"), "upper": ("radau_lo", "lobatto")},
	# every derivative > 0: exp(t·x) with t > 0
	"absolutely_monotone": {"lower": ("gauss", "radau_lo"), "upper": ("radau_hi", "lobatto")},
}
_BOUND_CLASSES["cm"] = _BOUND_CLASSES["completely_monotone"]
_BOUND_CLASSES["am"] = _BOUND_CLASSES["absolutely_monotone"]


def _bounds_probes(op, nv: int, pdf: str, seed) -> torch.Tensor:
	"""The ``(n, nv)`` real probe block of :func:`trace_bounds`: round 0 of ``seed``'s
	generator on the operator's device, in the operator's real dtype."""
	from .random import real_dtype, sample_isotropic
	from .trace import _base_seed, batch_generator

	gen = batch_generator(_base_seed(seed), 0, op.device)
	return sample_isotropic(gen, (op.shape[0], int(nv)), pdf=pdf, dtype=real_dtype(op.dtype))


def trace_bounds(
	A,
	fun: Union[str, callable] = "log",
	deg: int = 20,
	orth: int = -1,
	nv: int = 32,
	pdf: str = "rademacher",
	interval: Optional[tuple] = None,
	kind: Optional[str] = None,
	seed=None,
	full: bool = False,
	fun_kwargs: Optional[dict] = None,
):
	r"""Two-sided Golub-Meurant brackets of the SLQ estimate of ``tr(f(A))``.

	For functions whose derivatives have a constant sign on the spectral interval, the
	Gauss, Gauss-Radau and Gauss-Lobatto rules of each probe's Jacobi matrix bound
	``vᵀf(A)v`` from known sides (Golub & Meurant, *Matrices, Moments and Quadrature*,
	ch. 6-7): ``"bernstein"`` (log, sqrt: Radau at λmin and Lobatto below, Gauss and Radau
	at λmax above), ``"completely_monotone"`` (inv, exp(−tx): the reverse) and
	``"absolutely_monotone"`` (exp(+tx): Gauss and Radau at λmin below, Radau at λmax and
	Lobatto above). All four rules come from one Lanczos sweep of ``nv`` probes (full
	re-orthogonalisation by default); a Gram operator is bidiagonalised instead.

	``interval = (a, b)`` must hold the spectrum; by default a 32-step Rayleigh-Ritz sweep
	seeded by ``seed`` estimates it, padded (multiplicatively at a positive lower end for
	the log and inv classes). ``kind`` is inferred for "log", "sqrt", "inv" and "exp";
	a callable needs it. Returns ``(lower, upper)``: the tightest probe-averaged rule on
	each side, each an unbiased trace estimator whose quadrature bias has a known sign.
	With ``full=True`` a dict with every rule's mean, the per-probe samples, the interval
	and the Monte-Carlo standard error of the Gauss rule. The probes come from
	``_bounds_probes``.
	"""
	from .integrate import lobatto_rule, quadrature, radau_rule
	from .lanczos import lanczos_block_op
	from .operators.sparse import GramOperator
	from .random import real_dtype
	from .special import param_callable

	fun_kwargs = fun_kwargs or {}
	if kind is None:
		if fun == "log" or fun == "sqrt":
			kind = "bernstein"
		elif fun == "inv":
			kind = "completely_monotone"
		elif fun == "exp":
			kind = "absolutely_monotone" if fun_kwargs.get("t", 1.0) > 0 else "completely_monotone"
		else:
			raise ValueError(
				"trace_bounds cannot infer the derivative-sign class of a custom function; "
				"pass kind='bernstein' | 'completely_monotone' | 'absolutely_monotone'"
			)
	if kind not in _BOUND_CLASSES:
		raise ValueError(f"Unknown kind {kind!r}")
	f = param_callable(fun, **fun_kwargs) if isinstance(fun, str) else fun

	op = aslinop(A)
	n = op.shape[0]
	deg = int(min(deg, n))
	orth = deg if (orth < 0 or orth > deg) else int(orth)
	if interval is None:
		from .lanczos import rayleigh_ritz

		rw = rayleigh_ritz(op, deg=int(min(32, n)), orth=-1, seed=seed)
		lo, hi = float(torch.min(rw)), float(torch.max(rw))
		pad = 0.03 * max(hi - lo, 1e-12) + 1e-12
		a, b = lo - pad, hi + pad
		if kind in ("bernstein", "completely_monotone") and lo > 0 and a <= 0:
			# The Radau and Lobatto rules pin a node at a: log needs it positive, and 1/a < 0
			# would invert the completely monotone upper bound. Pad multiplicatively instead.
			a = 0.5 * lo
	else:
		a, b = float(interval[0]), float(interval[1])

	# Hermitian operators take real probes too: α, β and the four rules stay real.
	Vr = _bounds_probes(op, nv, pdf, seed)
	V = Vr.to(op.dtype)
	if isinstance(op, GramOperator):
		# Golub-Kahan on the data operator; the Radau coupling of BᵀB is α_deg·β_deg.
		from .bidiag import bidiag_jacobi, lanczos_bidiag_op

		deg = int(min(deg, min(op.A.shape)))
		out = lanczos_bidiag_op(op.A, V, deg=deg, orth=min(orth, deg), adjoint=not op.transpose_first, return_residual=True)
		dj, ej = bidiag_jacobi(out.alphas, out.betas)
		d, e = dj.T, ej.T
		beta_end = out.alphas[deg - 1] * out.residual
	else:
		out = lanczos_block_op(op, V, deg=deg, ncv=max(2, min(max(orth, 2), deg)), orth=orth, return_basis=False)
		d = out.alphas.T  # (nv, deg)
		e = out.betas[: deg - 1].T
		beta_end = out.betas[deg - 1]  # the final residual couples the Radau extension

	acc = real_dtype(torch.promote_types(op.dtype, torch.float32))
	norm2 = torch.sum(Vr.to(acc) ** 2, dim=0)

	def rule_estimates(nodes, weights):
		return torch.sum(f(nodes) * weights, dim=-1) * norm2  # per-probe quadratic forms

	th_g, w_g = quadrature(d, e, deg=deg)
	rules = {
		"gauss": rule_estimates(th_g, w_g),
		"radau_lo": rule_estimates(*radau_rule(d, e, beta_end, a)),
		"radau_hi": rule_estimates(*radau_rule(d, e, beta_end, b)),
		"lobatto": rule_estimates(*lobatto_rule(d, e, beta_end, a, b)),
	}
	means = {name: float(torch.mean(v)) for name, v in rules.items()}
	sides = _BOUND_CLASSES[kind]
	lower = max(means[r] for r in sides["lower"])
	upper = min(means[r] for r in sides["upper"])
	# Converged quadrature: the rules coincide to rounding, which can cross the bracket. A
	# crossing beyond rounding is kept: it flags an interval that misses the spectrum. JAX's
	# bound is 1e-9 relative, a float64 one; in float32 the rounding of the rules' means is
	# larger (an ulp of 1.5e6 is 0.125), so the bound is at least 32 ulps of the dtype.
	rounding = max(1e-9, 32.0 * torch.finfo(acc).eps)
	if upper < lower <= upper + rounding * max(1.0, abs(upper)):
		lower = upper = 0.5 * (lower + upper)
	if not full:
		return lower, upper
	return {
		"lower": lower,
		"upper": upper,
		"kind": kind,
		"interval": (a, b),
		"rules": means,
		"samples": {name: v.cpu().numpy() for name, v in rules.items()},
		"nv": int(nv),
		# The bracket bounds the quadrature bias; the Monte-Carlo spread of the probes remains.
		"mc_stderr": float(torch.std(rules["gauss"]) / np.sqrt(float(nv))),
	}


def trace_inv(
	A,
	deg: int = 30,
	orth: int = 5,
	method: str = "slq",
	precond=None,
	rtol: float = 1e-6,
	maxiter: Optional[int] = None,
	**kwargs,
):
	"""``tr(A⁻¹)``, e.g. the GP log-likelihood's gradient term.

	``method="slq"``: stochastic Lanczos quadrature of ``1/x``, ``deg`` applies a probe,
	its bias set by the degree. ``method="cg"``: Hutchinson over CG solves ``vᵀ(A⁻¹v)``,
	unbiased up to the solve's tolerance ``rtol``; ``precond`` is ``"jacobi"``,
	``"nystrom"`` (rank 64, seeded by ``seed``) or a prebuilt preconditioner, built once for
	every probe batch. Each batch is one batched :func:`~primate_tpu_torch.cg` solve.
	"""
	if method == "slq":
		return _slq(A, "inv", deg, orth, **kwargs)
	if method != "cg":
		raise ValueError(f"method must be 'slq' or 'cg', got {method!r}")
	from .operators import FunctionOperator
	from .solvers import _acc, _make_preconditioner, cg

	op = aslinop(A)
	pre = _make_preconditioner(op, precond, 64, kwargs.get("seed"), _acc(op.dtype))
	maxiter = None if maxiter is None else int(maxiter)
	inv_op = FunctionOperator(
		lambda V: cg(op, V, rtol=float(rtol), maxiter=maxiter, precond=pre), op.shape, dtype=op.dtype, device=op.device
	)
	return hutch(inv_op, **kwargs)


def effective_dim(A, lam: Union[float, np.ndarray] = 1.0, deg: int = 30, orth: int = 5, **kwargs):
	"""Effective dimension ``tr(A(A + λI)⁻¹)`` of a PSD operator (ridge and GP degrees of freedom).

	An array ``lam`` gives the whole curve from one sweep per probe batch (a stacked family).
	"""
	if np.ndim(lam) > 0:
		return _slq(A, _memo_fun("effdim_fam", *(float(v) for v in np.asarray(lam).ravel())), deg, orth, **kwargs)
	return _slq(A, _memo_fun("effdim", float(lam)), deg, orth, **kwargs)


def condition_number(A, k: int = 1, maxiter: int = 200, seed=None, method: str = "lobpcg", **eigsh_kwargs):
	"""2-norm condition number ``λ_max/λ_min`` of a symmetric positive-definite operator.

	Both ends by :func:`~primate_tpu_torch.eigsh` (``k`` pairs each side); raises
	``ValueError`` when the smallest eigenvalue found is ≤ 0.
	"""
	from .eigen import eigsh

	op = aslinop(A)
	kw = dict(k=k, maxiter=maxiter, seed=seed, method=method, return_eigenvectors=False, **eigsh_kwargs)
	w_hi = eigsh(op, which="LA", **kw)
	w_lo = eigsh(op, which="SA", **kw)
	lo, hi = float(torch.min(w_lo)), float(torch.max(w_hi))
	if lo <= 0:
		raise ValueError(f"condition_number requires a positive-definite operator; smallest eigenvalue ≈ {lo:.3e}")
	return hi / lo


def estrada_index(A, deg: int = 20, orth: int = 5, t: float = 1.0, **kwargs):
	"""Estrada index ``tr(exp(t·A))`` of a graph operator; an array ``t`` gives every point from one sweep."""
	if np.ndim(t) > 0:
		return _slq(A, stacked("exp", t), deg, orth, **kwargs)
	return _slq(A, "exp", deg, orth, fun_kwargs={"t": t}, **kwargs)


def heat_kernel_trace(A, t: Union[float, np.ndarray] = 1.0, deg: int = 20, orth: int = 5, **kwargs):
	"""Heat trace ``tr(exp(−t·A))`` of a Laplacian; an array ``t`` gives the curve from one sweep per batch."""
	if np.ndim(t) > 0:
		return _slq(A, stacked("exp", -np.asarray(t)), deg, orth, **kwargs)
	return _slq(A, "exp", deg, orth, fun_kwargs={"t": -t}, **kwargs)


def heat_kernel_signature(A, timepoints, deg: int = 20, orth: int = 5, **kwargs):
	"""Heat-kernel signature ``diag(exp(−t·A))`` at every ``t`` of ``timepoints``, ``(nt, n)``:
	one :func:`~primate_tpu_torch.diag` run over a stacked family, one sweep per probe."""
	from .diagonal import diag

	ts = np.atleast_1d(np.asarray(timepoints, dtype=float))
	M = MatrixFunction(aslinop(A), fun=stacked("exp", -ts), deg=deg, orth=orth)
	out = diag(M, **kwargs)
	if isinstance(out, tuple):
		est, result = out
		return np.asarray(est).reshape(len(ts), -1), result
	return np.asarray(out).reshape(len(ts), -1)


def numrank(A, threshold: float = 1e-6, deg: int = 20, orth: int = 5, **kwargs):
	"""Numerical rank: ``tr(step(A))``, the eigenvalues above ``threshold`` in magnitude, rounded."""
	est = _slq(A, "numrank", deg, orth, fun_kwargs={"threshold": threshold}, **kwargs)
	if isinstance(est, tuple):
		return (round(float(est[0])), *est[1:])
	return round(float(est))


def eigencount(A, interval: tuple, deg: int = 30, orth: int = 5, width: Optional[float] = None, **kwargs):
	"""Number of eigenvalues in ``interval = (a, b]``, rounded: ``tr`` of a window made of two
	cubic smoothsteps of transition ``width`` (default 2% of the interval), whose Gauss
	quadrature converges where the indicator's would not."""
	a, b = interval
	w = (0.02 * (b - a)) if width is None else float(width)
	est = _slq(A, _memo_fun("window", float(a), float(b), float(w)), deg, orth, **kwargs)
	if isinstance(est, tuple):
		return (round(float(est[0])), *est[1:])
	return round(float(est))


def schatten(A, p: Union[float, np.ndarray] = 1.0, deg: int = 20, orth: int = 5, gram: bool = False, **kwargs):
	"""Schatten p-norm ``(Σ σᵢᵖ)^{1/p}``: ``tr(|A|ᵖ)`` for a symmetric ``A``, or with
	``gram=True`` ``tr((AᵀA)^{p/2})`` of rectangular data through its Gram operator
	(Golub-Kahan, no Gram matrix formed). An array ``p`` gives every norm from one sweep."""
	multi = np.ndim(p) > 0
	ps = np.atleast_1d(np.asarray(p, dtype=float))
	if gram:
		from .operators import GramOperator

		op = GramOperator(aslinop(A))
		f = _memo_fun("grampow_fam", *(float(q) for q in ps)) if multi else _memo_fun("grampow", float(p))
		est = _slq(op, f, deg, orth, **kwargs)
	else:
		f = _memo_fun("abspow_fam", *(float(q) for q in ps)) if multi else _memo_fun("abspow", float(p))
		est = _slq(A, f, deg, orth, **kwargs)
	root = (lambda v: np.asarray(v) ** (1.0 / ps)) if multi else (lambda v: float(v) ** (1.0 / float(p)))
	if isinstance(est, tuple):
		return (root(est[0]), *est[1:])
	return root(est)


def bilinear_form(
	A,
	U,
	V=None,
	fun: Union[str, callable] = "identity",
	deg: int = 20,
	orth: int = 5,
	fun_kwargs: Optional[dict] = None,
	**mf_kwargs,
):
	"""Bilinear forms ``uᴴ f(A) v`` per column pair, by the polarization identity on
	Lanczos quadrature (Golub-Meurant):

	    uᵀ f(A) v = ¼ [ (u+v)ᵀ f(A) (u+v) − (u−v)ᵀ f(A) (u−v) ],

	one batched sweep over the ``2k`` vectors (``4k`` for a complex Hermitian ``A``, whose
	imaginary part needs ``u ± i·v``). Deterministic; exact when ``deg`` reaches the Krylov
	dimension. With ``U = e_i``, ``V = e_j`` it gives the entries ``f(A)[i, j]``.
	``V=None`` gives the quadratic forms ``uᴴ f(A) u``. ``U``, ``V``: ``(n,)`` or ``(n, k)``;
	the other keywords go to :class:`~primate_tpu_torch.MatrixFunction`. Returns a numpy
	array ``(k,)`` (a scalar array for vectors), or ``(nt, k)`` for a stacked ``fun``.
	"""
	M = MatrixFunction(aslinop(A), fun=fun, deg=deg, orth=orth, **(fun_kwargs or {}), **mf_kwargs)
	U = torch.as_tensor(U, device=M.device).to(M.dtype)
	single = U.ndim == 1
	U = U[:, None] if single else U
	if V is None:
		out = M.quad(U)
	else:
		V = torch.as_tensor(V, device=M.device).to(M.dtype)
		V = V[:, None] if V.ndim == 1 else V
		k = U.shape[1]
		if M.dtype.is_complex:
			P = torch.cat([U + V, U - V, U + 1j * V, U - 1j * V], dim=1)
			q = M.quad(P)
			re = (q[..., :k] - q[..., k : 2 * k]) / 4.0
			im = (q[..., 3 * k :] - q[..., 2 * k : 3 * k]) / 4.0  # q(u+iv) − q(u−iv) = −4·Im(u†Fv)
			out = torch.complex(re, im)
		else:
			q = M.quad(torch.cat([U + V, U - V], dim=1))
			out = (q[..., :k] - q[..., k:]) / 4.0
	out = out.cpu().numpy()
	return out[..., 0] if single else out


class _DiagWeights(LinearOperator):
	"""``diag(w)`` as an operator, on ``w``'s device."""

	def __init__(self, w: torch.Tensor):
		self.w = w
		self.shape = (w.shape[0], w.shape[0])
		self.dtype, self.device = w.dtype, w.device

	def _matmat(self, V: torch.Tensor) -> torch.Tensor:
		return self.w[:, None] * V.to(self.dtype)


class _PairedQuadOperator(LinearOperator):
	"""An operator whose quadratic form is ``Re (Bv)ᴴ f(A) v``: for isotropic ``v`` its mean
	is ``tr(B f(A))`` for a real or Hermitian ``B``, what :func:`weighted_trace` samples.
	Its apply is ``B f(A)``."""

	def __init__(self, M, B):
		self.M, self.B = M, B
		self.shape, self.dtype, self.device = M.shape, M.dtype, M.device

	@property
	def stack_shape(self):
		return getattr(self.M, "stack_shape", ())

	def quad(self, V) -> torch.Tensor:
		V = torch.as_tensor(V, device=self.device).to(self.dtype)
		V = V[:, None] if V.ndim == 1 else V
		with full_f32_matmul():
			FV = self.M.matmat(V)  # (n, k), or (nt, n, k) for a stacked family
			BV = self.B.matmat(V)
		# The bra conjugated (the package's quad-form convention): (Bv)ᴴ f(A) v = vᴴ B f(A) v
		# for a Hermitian B. A sum of products, no matmul.
		return torch.real(torch.sum(BV.conj() * FV, dim=-2))

	def _matmat(self, V: torch.Tensor) -> torch.Tensor:
		V = V.to(self.dtype)
		with full_f32_matmul():
			return self.B.matmat(self.M.matmat(V))


def weighted_trace(
	A,
	B,
	fun: Union[str, callable, None] = None,
	deg: int = 20,
	orth: int = 5,
	fun_kwargs: Optional[dict] = None,
	**est_kwargs,
):
	"""Weighted trace ``tr(f(A)·B)`` by paired Girard-Hutchinson sampling of ``(Bv)ᴴ f(A) v``.

	Unbiased for any real ``B`` (``E[vvᵀ] = I``); for complex probes the bra is conjugated
	and the real part taken, so a complex ``B`` must be Hermitian. A vector ``B`` is the
	diagonal ``diag(w)``: ``Σ wᵢ f(A)ᵢᵢ``. ``f(A)v`` is the Lanczos approximation of
	:class:`~primate_tpu_torch.MatrixFunction`; ``fun=None`` samples ``(Bv)ᵀ(Av)`` with no
	sweep. Takes the estimator knobs of :func:`~primate_tpu_torch.hutch`.
	"""
	opA = aslinop(A)
	if not isinstance(B, LinearOperator) and np.ndim(B) == 1:
		opB = _DiagWeights(torch.as_tensor(B, device=opA.device))
	else:
		opB = aslinop(B, device=opA.device)
	if fun is not None:
		opA = MatrixFunction(opA, fun=fun, deg=deg, orth=orth, **(fun_kwargs or {}))
	return hutch(_PairedQuadOperator(opA, opB), **est_kwargs)


def suggest_degree(
	A,
	fun: Union[str, callable] = "log",
	rtol: float = 1e-2,
	atol: float = 0.0,
	nv: int = 8,
	deg0: int = 8,
	max_deg: int = 256,
	orth: int = -1,
	pdf: str = "rademacher",
	interval: Optional[tuple] = None,
	kind: Optional[str] = None,
	seed=None,
	fun_kwargs: Optional[dict] = None,
	full: bool = False,
):
	"""Smallest Krylov degree whose quadrature bias is below tolerance, by measurement.

	Doubles ``deg`` from ``deg0``, computing :func:`trace_bounds` on the same ``nv`` probes
	each round (the same seed), so the bracket's width isolates the quadrature bias, and
	stops when ``upper − lower ≤ atol + rtol·|midpoint|`` or at ``max_deg``. The first
	round's spectral interval is reused. Returns the degree, or ``(deg, history)`` with
	``full=True``, the history's rows ``{"deg", "lower", "upper", "gap"}``.
	"""
	n = aslinop(A).shape[0]
	max_deg = int(min(max_deg, n))
	deg = int(min(max(deg0, 2), max_deg))
	history = []
	while True:
		res = trace_bounds(
			A, fun, deg=deg, orth=orth, nv=nv, pdf=pdf, interval=interval, kind=kind, seed=seed, full=True,
			fun_kwargs=fun_kwargs,
		)
		interval = res["interval"]
		lo, hi = float(res["lower"]), float(res["upper"])
		gap = hi - lo
		history.append({"deg": deg, "lower": lo, "upper": hi, "gap": gap})
		if gap <= atol + rtol * abs(0.5 * (lo + hi)) or deg >= max_deg:
			break
		deg = min(2 * deg, max_deg)
	return (deg, history) if full else deg


def suggest_probes(
	A=None,
	fun: Union[str, callable, None] = None,
	eps: float = 0.05,
	eta: float = 0.05,
	method: str = "auto",
	pilot: int = 32,
	deg: int = 20,
	orth: int = -1,
	pdf: str = "rademacher",
	seed=None,
	fun_kwargs: Optional[dict] = None,
	full: bool = False,
	conservative: bool = True,
	**kwargs,
):
	"""How many probes for a ``(1 ± eps)``-accurate trace with probability ``1 − eta``.

	``method="bound"``: the a-priori ``(24/eps²)·log(2/eta)`` Rademacher probes of the
	reference's documentation, for any PSD ``f(A)``, no operator needed. ``method="clt"``: one
	``pilot``-probe :func:`~primate_tpu_torch.hutch` run, and ``nv = (z·σ̄/(eps·|m̂|))²`` from
	its mean ``m̂`` and variance, where ``σ̄²`` is the χ² upper confidence bound
	``s²(m−1)/χ²_{eta, m−1}`` (``conservative=False``: ``s²`` itself); at least ``pilot``.
	``"auto"`` measures when an operator is given. ``fun`` wraps ``A`` in a
	:class:`~primate_tpu_torch.MatrixFunction` as the trace recipes do; other keywords reach
	the pilot. Returns ``nv``, or ``(nv, info)`` with ``full=True``.
	"""
	if not (0 < eps and 0 < eta < 1):
		raise ValueError("eps must be positive and eta in (0, 1)")
	if method == "auto":
		method = "clt" if A is not None else "bound"
	if method == "bound":
		nv = int(np.ceil((24.0 / eps**2) * np.log(2.0 / eta)))
		return (nv, {"method": "bound", "eps": eps, "eta": eta}) if full else nv
	if method != "clt":
		raise ValueError(f"Unknown method '{method}' (expected 'bound', 'clt', or 'auto')")
	if A is None:
		raise ValueError("method='clt' sizes probes from a pilot run: an operator is required")

	from .estimators import clt_quantiles

	op = aslinop(A) if not hasattr(A, "quad") else A
	if fun is not None:
		op = MatrixFunction(op, fun=fun, deg=deg, orth=orth, **(fun_kwargs or {}))
	pilot = max(int(pilot), 4)
	_, res = hutch(op, converge="count", count=pilot, batch=pilot, pdf=pdf, seed=seed, full=True, **kwargs)
	est = float(np.asarray(res.estimator.estimate))
	var = float(np.mean(np.diagonal(np.atleast_2d(np.asarray(res.estimator.converged_variance)))))
	var_used = var
	if conservative and var > 0.0 and np.isfinite(var):
		from scipy.stats import chi2

		var_used = var * (pilot - 1) / float(chi2.ppf(eta, pilot - 1))
	z, _ = clt_quantiles(1.0 - eta)
	target = eps * abs(est)
	if target == 0.0 or not np.isfinite(target):
		nv = pilot  # a zero or NaN pilot mean has no relative target
	else:
		nv = int(np.ceil(z * z * var_used / (target * target)))
	nv = max(nv, pilot)
	info = {"method": "clt", "pilot": pilot, "estimate": est, "variance": var, "variance_bound": var_used, "z": z}
	return (nv, info) if full else nv


def shifted_trace(
	A,
	fun: Union[str, callable] = "log",
	shifts=None,
	deg: int = 20,
	orth: int = 5,
	fun_kwargs: Optional[dict] = None,
	**est_kwargs,
):
	"""``tr(f(A + t·I))`` at every shift ``t`` from one Lanczos sweep per probe batch.

	Krylov spaces are shift-invariant, so the shifted Jacobi matrix is ``J + tI`` and one
	sweep gives the Gauss rule ``(θ + t, τ)`` of every shift: a curve costs the applies of
	one point, and its points share their probes. The GP noise sweep ``log det(K + σ²I)``::

	    curve = ptt.recipes.shifted_trace(K, "log", shifts=sigmas**2)

	Returns an array of ``len(shifts)`` estimates.
	"""
	from .special import param_callable

	if shifts is None:
		raise ValueError("Provide shifts= (an array of t values for tr(f(A + t·I)))")
	f = param_callable(fun, **(fun_kwargs or {})) if isinstance(fun, str) else fun
	fam = _shift_family(f, tuple(float(t) for t in np.atleast_1d(np.asarray(shifts)).ravel()))
	M = MatrixFunction(aslinop(A), fun=fam, deg=deg, orth=orth)
	return hutch(M, **est_kwargs)


def topk(A, k: int = 6, which: str = "LM", return_eigenvectors: bool = False, **eigsh_kwargs):
	"""Rank-``k`` eigenspace projector ``P = VVᴴ`` as a matrix-free operator (the reference
	table's "topk"): the ``k`` extremal eigenvectors by :func:`~primate_tpu_torch.eigsh`
	(``which`` as there), applied as two skinny GEMMs in full float32. With
	``return_eigenvectors=True`` returns ``(P, eigenvalues, V)``."""
	from .eigen import eigsh
	from .operators import FunctionOperator

	op = aslinop(A)
	ew, V = eigsh(op, k=k, which=which, **eigsh_kwargs)
	Vh = V.mH if V.is_complex() else V.T

	def project(X):
		with full_f32_matmul():
			return V @ (Vh @ X.to(V.dtype))

	proj = FunctionOperator(project, op.shape, dtype=V.dtype, device=op.device)
	return (proj, ew, V) if return_eigenvectors else proj


def tikhonov(A, B, lam: float = 1.0, rtol: float = 1e-8, maxiter: Optional[int] = None, **cg_kwargs):
	"""Tikhonov-regularised solve ``X = (A + λI)⁻¹ B`` (the reference table's "tikhonov"):
	one batched :func:`~primate_tpu_torch.cg` on the pencil ``A + λI``, every column of ``B``
	together. Other keywords (``precond``, ``full``, ...) reach ``cg``."""
	from .solvers import cg

	op = aslinop(A)
	if not (lam > 0 or cg_kwargs.get("precond") is not None):
		raise ValueError("lam must be positive (or supply a preconditioner for an SPD A)")
	return cg(op + float(lam), B, rtol=rtol, maxiter=maxiter, **cg_kwargs)


def pagerank(
	A,
	alpha: float = 0.85,
	v: Optional[torch.Tensor] = None,
	rtol: float = 1e-8,
	maxiter: Optional[int] = None,
	**cg_kwargs,
):
	"""Resolvent ``x = (1−α)·(I − α·A)⁻¹ v``: PageRank-style centrality (the reference
	table's "pagerank"). For a symmetric normalised adjacency ``A = D^{-1/2} W D^{-1/2}``,
	``I − αA`` is positive definite for ``α < 1`` and one :func:`~primate_tpu_torch.cg` on the
	pencil replaces the power iteration. ``v`` defaults to the uniform ``1/n``; an ``(n, m)``
	block solves ``m`` personalisations together. Other keywords reach ``cg``."""
	from .solvers import cg

	op = aslinop(A)
	n = op.shape[0]
	if not 0.0 < alpha < 1.0:
		raise ValueError(f"alpha must lie in (0, 1); got {alpha}")
	if v is None:
		v = torch.full((n,), 1.0 / n, dtype=torch.promote_types(op.dtype, torch.float32), device=op.device)
	M = (op * (-float(alpha))) + 1.0
	x = cg(M, torch.as_tensor(v, device=op.device), rtol=rtol, maxiter=maxiter, **cg_kwargs)
	if isinstance(x, tuple):  # full=True: (X, iterations, residuals)
		return ((1.0 - alpha) * x[0],) + x[1:]
	return (1.0 - alpha) * x
