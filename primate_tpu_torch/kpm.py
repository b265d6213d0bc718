"""Chebyshev / Kernel Polynomial Method (KPM): moment-based spectral sums.

Counterpart of ``primate_tpu/kpm.py``. The KPM expands ``tr(f(A))`` and the
spectral density in Chebyshev moments

	μ_j = (1/nv) Σ_v v† T_j(Ã) v,   Ã = (A − c·I)/r with spectrum in [-1, 1],

from the three-term recurrence ``T_{j+1} = 2Ã T_j − T_{j-1}``: one operator
apply per moment on the whole probe block, no orthogonalisation, no
eigensolve. Jackson damping removes Gibbs oscillations. The recurrence runs
probe-major, ``(nv, n)`` blocks through ``matmat_t``, which on a DIA operator is
the ``dia_stencil_t`` kernel (complex for a Hermitian operator). It updates its
carries in place: besides the probes (the bra) three blocks are alive, the two
carries and the new apply's output, on which ``2Ã T_j − T_{j-1}`` is finished.
The JAX package's ``lax.scan`` becomes a Python loop that enqueues device work
and reads the device only for the host-side reconstruction.

Chebyshev coefficients are computed on the host in float64 (the function
evaluated on a float64 CPU tensor at 4096 Gauss-Chebyshev nodes), as JAX does in
numpy, and stay real for Hermitian operators.
"""

from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch

from .operators.base import LinearOperator, aslinop, torch_dtype
from .ops.dia import row_dot
from .random import probe_dtype, real_dtype, sample_isotropic
from .special import param_callable
from .utils.profiling import annotate

__all__ = [
	"chebyshev_moments",
	"kpm_trace",
	"kpm_trace_core",
	"kpm_density",
	"jackson_coefficients",
	"suggest_chebyshev_degree",
	"ChebyshevFunction",
]


def _jackson(m: int) -> np.ndarray:
	k = np.arange(m)
	M = m + 1.0
	return ((M - k) * np.cos(np.pi * k / M) + np.sin(np.pi * k / M) / np.tan(np.pi / M)) / M


def jackson_coefficients(m: int) -> torch.Tensor:
	"""Jackson damping factors g_0..g_{m-1} (the optimal positive KPM kernel), float64 on the CPU."""
	return torch.from_numpy(_jackson(int(m)))


def _fresh(Y: torch.Tensor, *others: torch.Tensor) -> torch.Tensor:
	"""``Y``, or a copy of it where it shares memory with one of ``others``: the recurrence
	finishes each step in place on the apply's output, which must not be a carry."""
	ptr = Y.untyped_storage().data_ptr()
	return Y.clone() if any(ptr == t.untyped_storage().data_ptr() for t in others) else Y


def _scaled_apply(op, X: torch.Tensor, c: float, r: float, *keep: torch.Tensor) -> torch.Tensor:
	"""``Ã X = (A X − c X)/r`` on a probe-major block, in ``X``'s dtype, computed in place
	on a fresh apply output (never on ``X`` or ``keep``); out of place where the apply carries a
	gradient (autograd refuses an in-place op on a view of a Function's output, which an
	operator's ``matmat_t`` may return)."""
	AX = op.matmat_t(X).to(X.dtype)
	if AX.requires_grad:
		return (AX - c * X) / r
	AX = _fresh(AX, X, *keep)
	if c != 0.0:
		AX.sub_(X, alpha=c)
	return AX.div_(r)


def _next_term(op, Tm: torch.Tensor, Tm1: torch.Tensor, c: float, r: float, *keep: torch.Tensor) -> torch.Tensor:
	"""``2Ã T_j − T_{j-1}`` in place on the apply's output."""
	return _scaled_apply(op, Tm, c, r, Tm1, *keep).mul_(2.0).sub_(Tm1)


def _moment_scan(op, Vt: torch.Tensor, m: int, c: float, r: float) -> torch.Tensor:
	"""Per-probe moments ``μ_j^(v) = Re v† T_j(Ã) v`` for ``j < m`` of the probe-major
	block ``Vt (nv, n)`` → ``(m, nv)``, real (``primate_tpu/kpm.py:48-83``). The
	recurrence runs in ``Vt``'s dtype, the moments in ``promote_types(dtype, float32)``.
	Differentiable in the operator's tensors through its applies."""
	with annotate("primate.sweep"):
		acc = torch.promote_types(Vt.dtype, torch.float32)
		Vt = Vt.contiguous()
		bra = Vt.to(acc)
		moments = [row_dot(bra, Vt.to(acc))]
		if m > 1:
			Tm1, Tm = Vt, _scaled_apply(op, Vt, c, r)
			moments.append(row_dot(bra, Tm.to(acc)))
			for _ in range(2, m):
				Tm1, Tm = Tm, _next_term(op, Tm, Tm1, c, r, Vt)
				moments.append(row_dot(bra, Tm.to(acc)))
		return torch.stack(moments[:m])


def _spectral_interval(op, seed) -> Tuple[float, float]:
	"""A bracket ``[λmin, λmax]`` from a Rayleigh-Ritz sweep, inflated by 3%."""
	from .lanczos import rayleigh_ritz

	k = int(min(32, op.shape[0]))
	rw = rayleigh_ritz(op, deg=k, orth=-1, seed=seed).detach().cpu().numpy()
	lo, hi = float(rw.min()), float(rw.max())
	pad = 0.03 * max(hi - lo, 1e-12) + 1e-12
	return lo - pad, hi + pad


def _resolve_interval(op, interval, seed) -> Tuple[float, float]:
	"""``None``: the Rayleigh-Ritz bracket (tight, probabilistic); ``"gershgorin"``: the
	Gershgorin enclosure (guaranteed); anything else an explicit ``(lo, hi)``."""
	if interval is None:
		return _spectral_interval(op, seed)
	if isinstance(interval, str):
		if interval != "gershgorin":
			raise ValueError(f"Unknown interval spec {interval!r}")
		from .operators.prepare import gershgorin_interval

		return gershgorin_interval(op)
	return float(interval[0]), float(interval[1])


def _probes(op, nv: int, pdf, seed) -> torch.Tensor:
	"""The ``(n, nv)`` probe block of a moment sweep, in the operator's dtype: batch 0 of ``seed``."""
	from .trace import _base_seed, batch_generator

	g = batch_generator(_base_seed(seed), 0, op.device)
	return sample_isotropic(g, (op.shape[0], int(nv)), pdf=pdf, dtype=probe_dtype(op.dtype, pdf)).to(op.dtype)


def chebyshev_moments(
	A, m: int = 64, nv: int = 16, pdf: str = "rademacher", interval: Optional[Tuple[float, float]] = None, seed=None
) -> Tuple[np.ndarray, Tuple[float, float]]:
	"""The first ``m`` Chebyshev trace moments ``tr(T_j(Ã))`` from ``nv`` probes, not damped.
	Returns ``(moments (m,), (lmin, lmax))``."""
	op = aslinop(A)
	lo, hi = _resolve_interval(op, interval, seed)
	c, r = (hi + lo) / 2.0, (hi - lo) / 2.0
	with torch.no_grad():
		mus = torch.mean(_moment_scan(op, _probes(op, nv, pdf, seed).T, int(m), c, r), dim=1)
	return mus.double().cpu().numpy(), (lo, hi)


def _chebyshev_coefficients(fun: Callable, m: int, c: float, r: float, quad_points: int = 4096) -> np.ndarray:
	"""Chebyshev coefficients of ``f`` on ``[c-r, c+r]`` by Gauss-Chebyshev quadrature, float64,
	``(m,)`` or ``(nt, m)`` for a stacked family."""
	k = np.arange(quad_points)
	x = np.cos(np.pi * (k + 0.5) / quad_points)
	fx = fun(torch.from_numpy(c + r * x))
	fx = fx.detach().cpu().numpy() if isinstance(fx, torch.Tensor) else np.asarray(fx)
	j = np.arange(m)[:, None]
	Tjx = np.cos(j * np.arccos(x)[None, :])
	coeff = 2.0 / quad_points * np.einsum("jq,...q->...j", Tjx, fx.astype(np.float64))
	coeff[..., 0] /= 2.0
	return coeff


def _series_weights(fs, m: int, c: float, r: float, damping: str) -> tuple:
	"""``(a, g)``: per-function coefficients ``(nt, m)`` and damping ``(m,)``, host float64."""
	a = np.concatenate([np.atleast_2d(_chebyshev_coefficients(f, m, c, r)) for f in fs])
	g = _jackson(m) if damping == "jackson" else np.ones(m)
	return a, g


def _resolve_funs(fun, fun_kwargs) -> tuple:
	multi = isinstance(fun, (list, tuple)) or getattr(fun, "nout", None) is not None
	funs = list(fun) if isinstance(fun, (list, tuple)) else [fun]
	return multi, [param_callable(fi, **fun_kwargs) if (fi is None or isinstance(fi, str)) else fi for fi in funs]


def suggest_chebyshev_degree(
	fun: Union[str, Callable], interval: Tuple[float, float], rtol: float = 1e-8, max_deg: int = 2048,
	damping: str = "none", **fun_kwargs,
) -> int:
	"""Smallest Chebyshev degree resolving ``fun`` on ``interval`` to ``rtol``
	(``primate_tpu/kpm.py:164-220``): expand to ``max_deg`` coefficients and cut where
	their envelope falls below ``rtol·max|a_j|``. With Jackson damping, size against the
	damped error ``Σ_{j<m}|a_j|(1−g_j) + Σ_{j≥m}|a_j|`` over a geometric ladder of
	degrees (the best one when ``rtol`` is out of reach)."""
	f = param_callable(fun, **fun_kwargs) if (fun is None or isinstance(fun, str)) else fun
	lo, hi = float(interval[0]), float(interval[1])
	c, r = (hi + lo) / 2.0, max((hi - lo) / 2.0, 1e-30)
	a = _chebyshev_coefficients(f, int(max_deg), c, r)
	mag = np.max(np.abs(np.atleast_2d(a)).reshape(-1, a.shape[-1]), axis=0)
	scale = float(mag.max())
	if scale == 0.0 or not np.isfinite(scale):
		return 2
	if damping == "jackson":
		tail = np.concatenate([np.cumsum(mag[::-1])[::-1], [0.0]])
		best_m, best_err = 2, np.inf
		for m in sorted({int(v) for v in np.geomspace(2, int(max_deg), 40).round()}):
			err = float(np.sum(mag[:m] * (1.0 - _jackson(m))) + tail[m])
			if err < best_err:
				best_m, best_err = m, err
			if err <= rtol * scale:
				return int(max(2, m))
		return int(max(2, best_m))
	keep = np.nonzero(mag >= rtol * scale)[0]
	return int(max(2, (keep[-1] + 1) if keep.size else 1))


def kpm_trace_core(op, V: torch.Tensor, fs, m: int, interval: Tuple[float, float], damping: str = "jackson") -> torch.Tensor:
	"""``Σ_j g_j a_j μ_j`` per function ``(nt,)`` on a given probe block ``V (n, nv)``, as a tensor
	with a gradient to the operator's tensors (the path of ``kpm_trace(differentiable=True)``)."""
	lo, hi = float(interval[0]), float(interval[1])
	c, r = (hi + lo) / 2.0, (hi - lo) / 2.0
	mus = torch.mean(_moment_scan(op, V.T, int(m), c, r), dim=1)
	with annotate("primate.quadrature"):
		a, g = _series_weights(fs, int(m), c, r, damping)
		return torch.sum(torch.as_tensor(g * a, dtype=mus.dtype, device=mus.device) * mus, dim=-1)


def kpm_trace(
	A, fun: Union[str, Callable, None] = None, m: Union[int, str] = 64, nv: int = 32, pdf: str = "rademacher",
	interval: Optional[Tuple[float, float]] = None, damping: str = "jackson", seed=None, **fun_kwargs,
):
	"""``tr(f(A))`` by the Kernel Polynomial Method (``primate_tpu/kpm.py:223-285``):
	``Σ_j g_j a_j μ_j`` with the Chebyshev coefficients ``a_j`` of ``f``, the damping ``g_j``
	(``"jackson"`` or ``"none"``) and ``nv`` probes' moments, one apply per moment.

	A sequence of functions (or a stacked callable) shares one moment sweep and returns
	``(nt,)``. ``m="auto"`` sizes the degree by :func:`suggest_chebyshev_degree`.
	``differentiable=True`` (an explicit ``interval`` and a fixed ``m``; real or Hermitian operators)
	returns a tensor whose gradient reaches the operator's tensors through its applies.
	"""
	differentiable = fun_kwargs.pop("differentiable", False)
	multi, fs = _resolve_funs(fun, fun_kwargs)
	op = aslinop(A)
	with annotate("primate.estimate"):
		if differentiable:
			if interval is None or isinstance(interval, str):
				raise ValueError("kpm_trace(differentiable=True) needs an explicit interval=(lmin, lmax)")
			if m == "auto":
				raise ValueError("kpm_trace(differentiable=True) needs a fixed Chebyshev degree m")
			ests = kpm_trace_core(op, _probes(op, nv, pdf, seed), fs, int(m), interval, damping)
			return ests if multi or ests.shape[0] > 1 else ests[0]
		interval = _resolve_interval(op, interval, seed)
		if m == "auto":
			rt = 1e-3 if damping == "jackson" else 1e-8
			m = max(suggest_chebyshev_degree(f, interval, rtol=rt, damping=damping) for f in fs)
		mus, (lo, hi) = chebyshev_moments(op, m=m, nv=nv, pdf=pdf, interval=interval, seed=seed)
		with annotate("primate.quadrature"):
			c, r = (hi + lo) / 2.0, (hi - lo) / 2.0
			a, g = _series_weights(fs, int(m), c, r, damping)
			ests = (g * a * mus).sum(axis=-1)
			return ests if multi or a.shape[0] > 1 else float(ests[0])


def kpm_density(
	A, grid: Union[int, np.ndarray] = 256, m: int = 128, nv: int = 16, pdf: str = "rademacher",
	interval: Optional[Tuple[float, float]] = None, seed=None,
) -> Tuple[np.ndarray, np.ndarray]:
	"""KPM spectral density on a grid, Jackson-damped (``primate_tpu/kpm.py:288-320``):
	``φ(t) = [g₀μ₀ + 2Σ g_j μ_j T_j(x)] / (π√(1−x²)·n·r)``, mass 1, with ``x`` the mapped grid
	clamped to ``cos(π/2m)``. Returns ``(ts, phi)`` as numpy arrays."""
	op = aslinop(A)
	with annotate("primate.estimate"):
		interval = _resolve_interval(op, interval, seed)
		mus, (lo, hi) = chebyshev_moments(op, m=m, nv=nv, pdf=pdf, interval=interval, seed=seed)
		with annotate("primate.quadrature"):
			c, r = (hi + lo) / 2.0, (hi - lo) / 2.0
			ts = np.linspace(lo, hi, int(grid)) if np.isscalar(grid) else np.asarray(grid)
			xmax = float(np.cos(np.pi / (2 * m)))
			x = np.clip((ts - c) / r, -xmax, xmax)
			g = _jackson(m)
			j = np.arange(m)[:, None]
			Tjx = np.cos(j * np.arccos(x)[None, :])
			series = g[0] * mus[0] + 2.0 * (g[1:, None] * mus[1:, None] * Tjx[1:]).sum(axis=0)
			phi = series / (np.pi * np.sqrt(1.0 - x**2)) / (op.shape[0] * r)
			return ts, phi


class ChebyshevFunction(LinearOperator):
	"""Implicit ``f(A)`` by Chebyshev expansion (``primate_tpu/kpm.py:323-497``), the
	orthogonalisation-free complement of :class:`~primate_tpu_torch.MatrixFunction`.

	``matmat`` evaluates the degree-``deg`` approximant on the spectral interval by the
	Clenshaw recurrence (two carried blocks, one apply per term); ``quad`` returns the
	per-probe ``x† f(A) x = Σ_j g_j a_j (x† T_j(Ã) x)`` from the forward moment recurrence,
	real, so ``hutch(ChebyshevFunction(A, f))`` is the KPM with the estimators' criteria.
	A family of functions (a list, or a stacked callable) shares the recurrence and adds
	a leading axis ``(nt,)``. ``interval``: as in :func:`kpm_trace`; ``deg="auto"`` sizes
	the degree. A numpy or scipy ``A`` goes to ``device``.
	"""

	def __init__(
		self, A, fun: Union[str, Callable, None] = None, deg: Union[int, str] = 64, interval=None,
		damping: str = "jackson", dtype=None, seed=None, device="cuda", **fun_kwargs,
	):
		dtype = torch_dtype(dtype)
		self._op = aslinop(A, dtype=dtype, device=device)
		self.shape = self._op.shape
		self.dtype = dtype if dtype is not None else self._op.dtype
		self.device = self._op.device
		self._damping = damping
		lo, hi = _resolve_interval(self._op, interval, seed)
		self._interval = (lo, hi)
		c, r = (hi + lo) / 2.0, max((hi - lo) / 2.0, 1e-30)
		if isinstance(fun, (list, tuple)):
			fs = [param_callable(fi, **fun_kwargs) if (fi is None or isinstance(fi, str)) else fi for fi in fun]
			if deg == "auto":  # the family shares one degree, the largest its members need
				deg = max(suggest_chebyshev_degree(f, (lo, hi)) for f in fs)
			self._deg = int(deg)
			a = np.stack([_chebyshev_coefficients(f, self._deg, c, r) for f in fs])
		else:
			f = param_callable(fun, **fun_kwargs) if (fun is None or isinstance(fun, str)) else fun
			if deg == "auto":
				rt = 1e-3 if damping == "jackson" else 1e-8
				deg = suggest_chebyshev_degree(f, (lo, hi), rtol=rt, damping=damping)
			self._deg = int(deg)
			a = _chebyshev_coefficients(f, self._deg, c, r)
		g = _jackson(self._deg) if damping == "jackson" else np.ones(self._deg)
		# The damped coefficients are real for Hermitian operators too: f maps the real
		# spectrum to reals. Kept on the host (the Clenshaw axpys take them as scalars)
		# and on the device in the real accumulation dtype.
		self._ga_host = g * a
		self._ga = torch.as_tensor(self._ga_host, dtype=real_dtype(torch.promote_types(self.dtype, torch.float32)), device=self.device)
		self._c, self._r = c, r

	@property
	def interval(self) -> Tuple[float, float]:
		return self._interval

	@property
	def degree(self) -> int:
		return self._deg

	@property
	def operator(self) -> LinearOperator:
		return self._op

	@property
	def stack_shape(self) -> Tuple[int, ...]:
		"""Leading stack axes of ``matmat``/``quad`` outputs: ``(nt,)`` for a family, else ``()``."""
		return (int(self._ga.shape[0]),) if self._ga.ndim > 1 else ()

	def float_tensors(self) -> tuple:
		return self._op.float_tensors()

	def _matmat(self, V: torch.Tensor) -> torch.Tensor:
		"""``f(A) V`` by Clenshaw, ``b_k = ga_k·V + 2Ã b_{k+1} − b_{k+2}``, probe-major; a family
		gives ``(nt, n, b)``. The carries ``(nt, b, n)`` are updated in place on each apply's output."""
		acc = torch.promote_types(self.dtype, torch.float32)
		Vt = torch.as_tensor(V, device=self.device).to(self.dtype).T.to(acc).contiguous()  # (b, n)
		ga = np.atleast_2d(self._ga_host)  # (nt, m)
		nt, m = ga.shape
		c, r = self._c, self._r

		def term(k: int) -> torch.Tensor:  # ga_k·V for every member, (nt, b, n)
			out = torch.empty((nt,) + Vt.shape, dtype=acc, device=self.device)
			for i in range(nt):
				torch.mul(Vt, float(ga[i, k]), out=out[i])
			return out

		def app(B: torch.Tensor, *keep: torch.Tensor) -> torch.Tensor:  # Ã over the member axis
			return _scaled_apply(self._op, B.reshape(-1, B.shape[-1]), c, r, Vt, *keep).reshape(B.shape)

		if m == 1:
			out = term(0)
		else:
			# b_{m-1} = ga_{m-1}·V (Ã·0 = 0), then b_k for k = m-2 … 1, and the last step.
			b2, b1 = None, term(m - 1)
			for k in range(m - 2, 0, -1):
				b = app(b1, *(() if b2 is None else (b2,))).mul_(2.0)
				if b2 is not None:
					b.sub_(b2)
				for i in range(nt):
					b[i].add_(Vt, alpha=float(ga[i, k]))
				b2, b1 = b1, b
			out = app(b1, *(() if b2 is None else (b2,)))
			if b2 is not None:
				out.sub_(b2)
			for i in range(nt):
				out[i].add_(Vt, alpha=float(ga[i, 0]))
		out = out.transpose(-1, -2)  # (nt, n, b)
		if self._ga.ndim == 1:
			out = out[0]
		return out.to(self.dtype)

	def quad(self, X) -> torch.Tensor:
		"""Per-probe ``x† f(A) x`` from the forward moment recurrence, real: ``(b,)``, or ``(nt, b)``
		for a family (one recurrence for all members)."""
		acc = torch.promote_types(self.dtype, torch.float32)
		X = torch.as_tensor(X, device=self.device).to(self.dtype)
		single = X.ndim == 1
		Xt = (X[:, None] if single else X).T.to(acc)
		mus = _moment_scan(self._op, Xt, self._deg, self._c, self._r)  # (m, b)
		ga = torch.atleast_2d(self._ga).to(mus.dtype)  # (nt, m)
		out = torch.sum(ga[:, :, None] * mus[None], dim=1)  # (nt, b)
		if self._ga.ndim == 1:
			out = out[0]
		out = out.to(real_dtype(self.dtype))
		return out[..., 0] if single else out
