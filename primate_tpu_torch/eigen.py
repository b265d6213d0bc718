"""Extremal and interior eigenpairs and low-rank factors of implicit operators.

Counterpart of ``primate_tpu/eigen.py``: ``eigsh`` (blocked LOBPCG or thick-restart
Lanczos, with spectral shifts for "SA", "LM" and "BE"), ``filtered_eigsh`` (spectrum
slicing by Chebyshev-Jackson filtered subspace iteration), ``svds`` (``eigsh`` on the
smaller Gram side), ``rsvd`` (randomised range finder) and ``rand_nystrom``
(shift-stabilised Nyström). Results are tensors on the operator's device.

LOBPCG: the JAX package calls ``jax.experimental.sparse.linalg.lobpcg_standard``;
:func:`_lobpcg_standard` follows it step for step (SVQB orthonormalisation twice,
the "twice is enough" projection that zeroes suspicious residual columns, the
orthonormal 3k search space ``[X, P, R]``, its Rayleigh-Ritz step, the difference
directions from ``Q[:k, k:]``, and its self-consistency convergence test and ``tol``
default). ``torch.lobpcg`` takes a tensor, not an operator, and stops differently.
Its loop reads the converged count once an iteration; thick-restart Lanczos reads
its stop test once a cycle and ``filtered_eigsh`` once a subspace iteration, where
the JAX package runs ``lax.while_loop``. Every GEMM, QR, Cholesky and eigensolve of
these exact identities runs under :func:`~primate_tpu_torch.linalg.full_f32_matmul`.
The blocks reach the operator node-major ``(n, k)`` (LOBPCG, the Rayleigh-Ritz
steps: on a DIA operator ``dia_stencil``, on a BSR one ``bsr_spmm``) or as single
probe-major vectors (thick-restart Lanczos: ``dia_stencil_t``).
"""

import warnings
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from .linalg import full_f32_matmul
from .operators.base import LinearOperator, aslinop, torch_dtype
from .random import real_dtype

__all__ = ["eigsh", "filtered_eigsh", "rand_nystrom", "rsvd", "svds", "ITERATIONS"]

# Iterations of the last solve of each kind: LOBPCG iterations, thick-restart cycles,
# filtered subspace iterations (read by callers that report them).
ITERATIONS = {"lobpcg": 0, "trlan": 0, "filtered_eigsh": 0}


def _h(X: torch.Tensor) -> torch.Tensor:
	return X.mH if X.is_complex() else X.T


def _sym(H: torch.Tensor) -> torch.Tensor:
	"""The Hermitian part, as ``jnp.linalg.eigh`` symmetrises its input."""
	return 0.5 * (H + _h(H))


def _col_norm(X: torch.Tensor) -> torch.Tensor:
	return torch.linalg.vector_norm(X, dim=0, keepdim=True)


# --- LOBPCG (jax/experimental/sparse/linalg.py: lobpcg_standard and its helpers) ---


def _eigh_descending(A: torch.Tensor):
	w, V = torch.linalg.eigh(_sym(A))
	return torch.flip(w, [0]), torch.flip(V, [1])


def _svqb(X: torch.Tensor) -> torch.Tensor:
	"""A truncated orthonormal basis of ``X`` by SVQB: the columns normalised, the
	eigenbasis of ``XᵀX``, directions with an eigenvalue below ``eps·max`` zeroed."""
	norms = _col_norm(X)
	X = X / torch.where(norms == 0, 1.0, norms)
	inner = X.T @ X
	w, V = _eigh_descending(inner)
	tau = torch.finfo(X.dtype).eps * w[0]
	padded = torch.maximum(w, tau)
	sqrted = torch.where(tau > 0, padded, 1.0) ** (-0.5)
	orthoX = X @ (V * sqrted[None, :])
	keep = ((w > tau) & (torch.diagonal(inner) > 0.0))[None, :]
	orthoX = orthoX * keep.to(orthoX.dtype)
	norms = _col_norm(orthoX)
	keep = keep & (norms > 0.0)
	return orthoX / torch.where(keep, norms, 1.0)


def _orthonormalize(basis: torch.Tensor) -> torch.Tensor:
	for _ in range(2):
		basis = _svqb(basis)
	return basis


def _project_out(basis: torch.Tensor, U: torch.Tensor) -> torch.Tensor:
	"""``U``'s part orthogonal to the orthonormal (zero columns allowed) ``basis``, orthonormal,
	with every column that may still lean on ``basis`` zeroed."""
	for _ in range(2):
		U = U - basis @ (basis.T @ U)
		U = _orthonormalize(U)
	for _ in range(2):
		U = U - basis @ (basis.T @ U)
	return U * (_col_norm(U) >= 0.99).to(U.dtype)


def _rayleigh_ritz_orth(matmat: Callable, S: torch.Tensor):
	return _eigh_descending(S.T @ matmat(S))


def _extend_basis(X: torch.Tensor, m: int) -> torch.Tensor:
	"""``m`` directions orthonormal to each other and to the orthonormal ``X (n, k)``, by a
	block Householder reflector (deterministic)."""
	n, k = X.shape
	Xupper, Xlower = X[:k], X[k:]
	u, s, vt = torch.linalg.svd(Xupper)
	y = torch.cat([Xupper + u @ vt, Xlower], dim=0)
	other = torch.cat([torch.eye(m, dtype=X.dtype, device=X.device), torch.zeros((n - k - m, m), dtype=X.dtype, device=X.device)])
	w = y @ (vt.T * ((2 * (1 + s)) ** (-0.5))[None, :])
	h = -2 * (w @ (w[k:, :].T @ other))
	h[k:] += other
	return h


def _lobpcg_standard(matmat: Callable, X: torch.Tensor, m: int = 100, tol: Optional[float] = None):
	"""The top-``k`` eigenpairs of the symmetric operator ``matmat`` from the start block
	``X (n, k)`` by LOBPCG, as ``lobpcg_standard`` computes them: ``(theta (k,)`` descending,
	``U (n, k), iterations)``. An eigenpair has converged when ``‖Av − θv‖ <
	tol·10·n·(‖Av‖ + θ)``; ``tol`` defaults to the dtype's epsilon. Needs ``0 < 5k < n``."""
	n, k = X.shape
	if k == 0 or 5 * k >= n:
		raise ValueError(f"expected 0 < search dim * 5 < matrix dim (got {k * 5}, {n})")
	if tol is None:
		tol = float(torch.finfo(X.dtype).eps)
	with full_f32_matmul():
		X = _orthonormalize(X)
		P = _extend_basis(X, k)
		AX = matmat(X)
		theta = torch.sum(X * AX, dim=0)
		R = AX - theta[None, :] * X
		it, converged = 0, 0
		while it < m and converged < k:
			R = _project_out(torch.cat([X, P], dim=1), R)
			XPR = torch.cat([X, P, R], dim=1)
			theta, Q = _rayleigh_ritz_orth(matmat, XPR)
			B = Q[:, :k]
			B = B / _col_norm(B)
			X = XPR @ B
			X = X / _col_norm(X)
			# The next search directions: (0, Q[k:, :k]) orthogonalised against Q[:, :k] in
			# the projected basis, then mapped through the orthonormal XPR.
			q, _ = torch.linalg.qr(Q[:k, k:].T)
			P = XPR @ (Q[:, k:] @ q)
			normP = _col_norm(P)
			P = P / torch.where(normP == 0, 1.0, normP)
			AX = matmat(X)
			theta = theta[:k]
			R = AX - theta[None, :] * X
			reltol = (torch.linalg.vector_norm(AX, dim=0) + theta) * n * 10
			converged = int(torch.count_nonzero(torch.linalg.vector_norm(R, dim=0) < tol * reltol))  # one read an iteration
			it += 1
	ITERATIONS["lobpcg"] = it
	return theta, X, it


def _lobpcg_top(matmat, matvec, n: int, k: int, dtype, gen: torch.Generator, maxiter: int, tol):
	X0 = torch.randn((n, k), generator=gen, dtype=dtype, device=gen.device)
	theta, U, _ = _lobpcg_standard(matmat, X0, m=maxiter, tol=tol)
	return theta, U


# --- Thick-restart Lanczos ---


def _trlan_cycle(matvec, Vt: torch.Tensor, lam, s, ell: int, gen: torch.Generator, *, m: int, keep: int):
	"""One thick-restart cycle (``primate_tpu/eigen.py:40-96``): extend the basis to ``m``
	Lanczos vectors, eigendecompose the projected matrix, compress to ``keep`` Ritz pairs.

	``Vt (m+1, n)``: rows ``[0, ell)`` the kept Ritz vectors, row ``ell`` the next start;
	``lam``, ``s`` ``(m,)``: the kept Ritz values and residual couplings
	(``A·v_i = λ_i·v_i + s_i·v_ell``). Each step projects ``[w, r]`` together off the
	written rows (CGS2, one pass over the basis for both): ``r`` is a fresh random
	direction that replaces ``w`` on a breakdown, chosen on the card without a read.
	"""
	n = Vt.shape[1]
	dtype, device = Vt.dtype, Vt.device
	eps = torch.finfo(dtype).eps
	idx = torch.arange(m + 1, device=device)
	kept = (idx[:m] < ell).to(dtype)
	e_ell = (idx[:m] == ell).to(dtype)
	col = torch.where(idx[:m] < ell, s, 0.0)
	T = torch.diag(lam * kept) + torch.outer(col, e_ell) + torch.outer(e_ell, col)
	beta_last = torch.zeros((), dtype=dtype, device=device)
	for j in range(ell, m):
		v = Vt[j]
		w = matvec(v)
		alpha = torch.dot(v, w)
		mask = (idx <= j).to(dtype)
		W2 = torch.stack([w, torch.randn(n, generator=gen, dtype=dtype, device=device)])
		for _ in range(2):
			W2 = W2 - ((W2 @ Vt.T) * mask[None, :]) @ Vt
		w, r = W2[0], W2[1]
		beta = torch.linalg.vector_norm(w)
		ok = beta > 10.0 * eps * (torch.abs(alpha) + beta + 1.0)
		bet = torch.where(ok, beta, 0.0) if j + 1 < m else torch.zeros_like(beta)
		jp = min(j + 1, m - 1)
		T[j, j] += alpha
		T[j, jp] += bet
		T[jp, j] += bet
		renewed = r / torch.clamp(torch.linalg.vector_norm(r), min=eps)
		Vt[j + 1] = torch.where(ok, w / torch.clamp(beta, min=eps), renewed)
		beta_last = torch.where(ok, beta, 0.0)
	theta, Y = torch.linalg.eigh(T)
	order = torch.argsort(-theta)
	sel = order[:keep]
	resid = beta_last * torch.abs(Y[m - 1, :])
	lam_new = torch.zeros(m, dtype=dtype, device=device)
	lam_new[:keep] = theta[sel]
	s_new = torch.zeros(m, dtype=dtype, device=device)
	s_new[:keep] = beta_last * Y[m - 1, sel]
	Vt_new = torch.zeros_like(Vt)
	Vt_new[:keep] = Y[:, sel].T @ Vt[:m]
	Vt_new[keep] = Vt[m]
	return Vt_new, lam_new, s_new, theta[order], resid[order]


def _trlan_top(matmat, matvec, n: int, k: int, dtype, gen: torch.Generator, maxiter: int, tol, v0=None):
	"""The top-``k`` eigenpairs by thick-restart Lanczos (Wu-Simon 2000; ``primate_tpu/eigen.py:99-151``):
	cycles of ``m − ℓ`` probe-major matvecs, each followed by CGS2 against the ``(m+1, n)``
	basis, one ``m × m`` eigensolve and one compression GEMM, until the first ``k`` Ritz
	residuals are below ``tol·max|θ|`` (read once a cycle) or the cycle budget is spent.
	``v0``: the start vector (default: normal, from ``gen``)."""
	if n < k + 4:
		raise ValueError(f"thick-restart Lanczos needs n ≥ k+4; got k={k}, n={n}")
	m = int(min(n - 1, max(3 * k, k + 12)))
	keep = min(max(k, min(2 * k, k + 8)), m - 2)
	tol = float(np.sqrt(torch.finfo(dtype).eps)) if tol is None else float(tol)
	span = max(1, m - keep)
	ncycles = int(np.clip((int(maxiter) * max(k, 1)) // span + 1, 10, 500))
	device = gen.device
	if v0 is None:
		v0 = torch.randn(n, generator=gen, dtype=dtype, device=device)
	v0 = torch.as_tensor(v0, dtype=dtype, device=device)
	Vt = torch.zeros((m + 1, n), dtype=dtype, device=device)
	with full_f32_matmul():
		Vt[0] = v0 / torch.linalg.vector_norm(v0)
		lam = torch.zeros(m, dtype=dtype, device=device)
		s = torch.zeros(m, dtype=dtype, device=device)
		ell, it = 0, 0
		while it < ncycles:
			Vt, lam, s, theta, resid = _trlan_cycle(matvec, Vt, lam, s, ell, gen, m=m, keep=keep)
			ell, it = keep, it + 1
			scale = torch.clamp(torch.max(torch.abs(theta)), min=1e-30)
			if bool(torch.all(resid[:k] <= tol * scale)):  # one read a cycle
				break
	ITERATIONS["trlan"] = it
	return lam[:k], Vt[:k].T


# --- Complex (Hermitian) operators through their real image ---


class _Realified(LinearOperator):
	"""The real symmetric ``2n × 2n`` image ``[[B, −C], [C, B]]`` of a Hermitian ``A = B + iC``:
	the same spectrum, each eigenvalue twice; a real eigenvector ``[u_r; u_i]`` collapses to
	the complex eigenvector ``u_r + i·u_i``. One complex apply per product."""

	def __init__(self, op):
		self._op = op
		n = op.shape[0]
		self.shape = (2 * n, 2 * n)
		self.dtype, self.device = real_dtype(op.dtype), op.device

	def _matmat(self, V: torch.Tensor) -> torch.Tensor:
		n = self._op.shape[0]
		Y = self._op.matmat(torch.complex(V[:n], V[n:]).to(self._op.dtype))
		return torch.cat([Y.real, Y.imag], dim=0).to(V.dtype)

	def matmat_t(self, Vt: torch.Tensor) -> torch.Tensor:
		n = self._op.shape[0]
		Y = self._op.matmat_t(torch.complex(Vt[:, :n], Vt[:, n:]).to(self._op.dtype))
		return torch.cat([Y.real, Y.imag], dim=1).to(Vt.dtype)


def _collapse_realified(w2: torch.Tensor, V2: torch.Tensor, k: int, order) -> Tuple[torch.Tensor, torch.Tensor]:
	"""At most ``k`` distinct complex eigenpairs from realified ones (``primate_tpu/eigen.py:179-208``):
	each candidate is projected off the kept vectors and kept when at least 0.3 of it remains
	(a phase-rotated copy of a kept direction leaves nothing), so a degenerate eigenspace keeps
	all its dimensions. One read per candidate."""
	n = V2.shape[0] // 2
	U = torch.complex(V2[:n], V2[n:])
	keep_w, keep_u = [], []
	for i in order:
		u = U[:, i]
		nrm = float(torch.linalg.vector_norm(u))
		if nrm < 1e-10:
			continue
		u = u / nrm
		for uj in keep_u:
			u = u - torch.vdot(uj, u) * uj
		res = float(torch.linalg.vector_norm(u))
		if res < 0.3:
			continue
		keep_w.append(w2[i])
		keep_u.append(u / res)
		if len(keep_w) == k:
			break
	if not keep_u:
		return w2[:0], U[:, :0]
	return torch.stack(keep_w), torch.stack(keep_u, dim=1)


def _upper_bound(op, seed) -> float:
	"""An inflated upper bound of the spectrum from a Rayleigh-Ritz sweep."""
	from .lanczos import rayleigh_ritz

	rw = rayleigh_ritz(op, deg=int(min(32, op.shape[0])), orth=-1, seed=seed)
	lo, hi = float(torch.min(rw)), float(torch.max(rw))
	return hi + 0.1 * max(hi - lo, 1.0)


def _generators(seed, device) -> Tuple[torch.Generator, torch.Generator]:
	from .trace import _base_seed, batch_generator

	base = _base_seed(seed)
	return batch_generator(base, 1, device), batch_generator(base, 2, device)


def eigsh(
	A,
	k: int = 6,
	which: str = "LA",
	maxiter: int = 200,
	tol: Optional[float] = None,
	return_eigenvectors: bool = True,
	seed=None,
	dtype=None,
	method: str = "lobpcg",
	device="cuda",
):
	"""Extremal eigenpairs of a symmetric or Hermitian operator, scipy-``eigsh``-shaped
	(``primate_tpu/eigen.py:221-352``): ``(w, V)`` with ``w`` ascending and the eigenvectors
	as columns, or ``w`` alone.

	``which``: "LA" (largest), "SA" (smallest: the largest of ``cI − A`` with ``c`` an
	inflated Rayleigh-Ritz bound), "LM" (largest magnitude: both ends, deduplicated) or
	"BE" (⌈k/2⌉ from the top, ⌊k/2⌋ from the bottom). ``method``: "lobpcg" (blocked,
	robust to clusters) or "trlan" (thick-restart Lanczos). A few guard vectors are solved
	for beyond ``k`` and dropped. An operator too small for LOBPCG (``5(k+2) ≥ n``) is
	densified and solved by ``torch.linalg.eigh``. A complex (Hermitian) operator is solved
	through its real ``2n`` image and folded back. ``device``: where a numpy or scipy ``A``
	goes; the results lie on the operator's device.
	"""
	op = aslinop(A, dtype=torch_dtype(dtype), device=device)
	n = op.shape[0]
	if not 0 < k < n:
		raise ValueError(f"k must be in (0, n); got k={k}, n={n}")
	which, method = which.upper(), method.lower()
	if which not in ("LA", "SA", "LM", "BE"):
		raise ValueError(f"Unknown which='{which}'")
	if method not in ("lobpcg", "trlan"):
		raise ValueError(f"Unknown method='{method}'")
	solve_top = _trlan_top if method == "trlan" else _lobpcg_top
	f_dtype = torch.promote_types(op.dtype, torch.float32)
	is_cplx = op.dtype.is_complex

	def done(w, V):
		asc = torch.argsort(w)
		w, V = w[asc], V[:, asc]
		return (w, V) if return_eigenvectors else w

	if 5 * (k + 2) >= n or (is_cplx and 5 * (min(2 * k + 2, 2 * n - 1) + 2) >= 2 * n):
		with full_f32_matmul():
			ws, Vs = torch.linalg.eigh(_sym(op.todense().to(f_dtype)))
		if which == "LA":
			sel = torch.arange(n - k, n)
		elif which == "SA":
			sel = torch.arange(k)
		elif which == "LM":
			sel = torch.sort(torch.argsort(-torch.abs(ws))[:k].cpu()).values
		else:  # BE: k//2 from the low end, the rest from the high end
			sel = torch.cat([torch.arange(k // 2), torch.arange(n - (k - k // 2), n)])
		sel = sel.to(ws.device)
		w, V = ws[sel], Vs[:, sel]
		return (w, V) if return_eigenvectors else w

	kw = dict(maxiter=maxiter, tol=tol, seed=seed, method=method)
	if is_cplx:
		if which == "BE":
			k_top, k_bot = (k + 1) // 2, k // 2
			w, V = eigsh(op, k=k_top, which="LA", **kw)
			if k_bot > 0:
				w_b, V_b = eigsh(op, k=k_bot, which="SA", **kw)
				w, V = torch.cat([w_b, w]), torch.cat([V_b, V], dim=1)
			return done(w, V)
		k2 = min(2 * k + 2, 2 * n - 1)
		w2, V2 = eigsh(_Realified(op), k=k2, which=which, **kw)
		key = {"LA": -w2, "SA": w2, "LM": -torch.abs(w2)}[which]
		w, V = _collapse_realified(w2, V2, k, torch.argsort(key).tolist())
		return done(w, V)

	g_lo, g_hi = _generators(seed, op.device)
	pad = min(max(2, k // 4), n - k - 1, max(0, (n - 1) // 5 - k)) if n - k > 1 else 0

	def mm(X):
		return op.matmat(X.to(op.dtype)).to(f_dtype)

	def mv(v):
		return op.matmat_t(v[None, :].to(op.dtype))[0].to(f_dtype)

	def top(kk, gen):
		th, U = solve_top(mm, mv, n, kk, f_dtype, gen, maxiter, tol)
		return th[:kk], U  # both solvers give θ descending

	def bottom(kk, gen, c):
		th, U = solve_top(lambda X: c * X - mm(X), lambda v: c * v - mv(v), n, kk, f_dtype, gen, maxiter, tol)
		return c - th[:kk], U

	if which == "LA":
		th, U = top(k + pad, g_hi)
		return done(th[:k], U[:, :k])
	if which == "SA":
		th, U = bottom(k + pad, g_lo, _upper_bound(op, seed))
		return done(th[:k], U[:, :k])
	k_top = (k + 1) // 2 if which == "BE" else k
	k_bot = k // 2 if which == "BE" else k
	th_t, U_t = top(k_top + pad, g_hi)
	th_b, U_b = bottom(k_bot + pad, g_lo, _upper_bound(op, seed))
	cand_w = torch.cat([th_t[:k_top], th_b[:k_bot]])
	cand_V = torch.cat([U_t[:, :k_top], U_b[:, :k_bot]], dim=1)
	order = torch.argsort(-torch.abs(cand_w))[:k].tolist() if which == "LM" else list(range(cand_w.shape[0]))
	with full_f32_matmul():
		overlap = torch.abs(cand_V.T @ cand_V).cpu().numpy()
	keep: list = []
	for i in order:  # the same pair found from both ends: nearly parallel vectors
		if all(overlap[i, j] < 0.5 for j in keep):
			keep.append(int(i))
		if len(keep) == k:
			break
	return done(cand_w[keep], cand_V[:, keep])


def _gaussian_sketch(gen: torch.Generator, shape, dtype) -> torch.Tensor:
	"""A standard Gaussian test matrix, complex (unit variance) for a complex dtype."""
	if dtype.is_complex:
		rd = real_dtype(dtype)
		re = torch.randn(shape, generator=gen, dtype=rd, device=gen.device)
		im = torch.randn(shape, generator=gen, dtype=rd, device=gen.device)
		return (torch.complex(re, im) * float(np.sqrt(0.5))).to(dtype)
	return torch.randn(shape, generator=gen, dtype=dtype, device=gen.device)


def _empty_slice(op, n: int):
	f_dtype = torch.promote_types(op.dtype, torch.float32)
	return torch.zeros(0, dtype=real_dtype(f_dtype), device=op.device), torch.zeros((n, 0), dtype=op.dtype, device=op.device)


def filtered_eigsh(
	A,
	interval: Tuple[float, float],
	k: Optional[int] = None,
	deg: Optional[int] = None,
	maxiter: int = 30,
	tol: Optional[float] = None,
	oversample: Optional[int] = None,
	spectral_interval: Optional[Tuple[float, float]] = None,
	seed=None,
	dtype=None,
	device="cuda",
):
	"""Every eigenpair in ``interval = (a, b)`` by Chebyshev-Jackson filtered subspace
	iteration (Zhou-Saad; ``primate_tpu/eigen.py:355-565``): ``(w, V)``, ``w`` ascending.

	Each iteration applies the degree-``deg`` bandpass ``ρ(A)`` (a
	:class:`~primate_tpu_torch.kpm.ChebyshevFunction` of a difference of smoothsteps,
	transition 2% of the slice, Jackson-damped; ``deg`` by default ``8·range/width``,
	clamped to [32, 600]) to the ``(n, s)`` subspace (``s = k`` plus ``max(6, k/4)`` or
	``oversample``), then one thin QR and one ``s × s`` Rayleigh-Ritz step. Iterations stop
	when every Ritz pair inside has a relative residual below ``tol`` (default
	``max(1e-6, √eps)``), on a stall (four iterations with no new converged pair and no 10%
	gain), or when the slice fills the subspace (then it grows by fresh directions). Pairs
	inside with residuals above ``10·tol`` are dropped with a warning. ``k``, the expected
	count, defaults to :func:`~primate_tpu_torch.recipes.eigencount` of the slice (seeded by
	``seed``, at its defaults), at least 1. ``spectral_interval`` defaults to a Rayleigh-Ritz bracket.
	"""
	from .kpm import ChebyshevFunction, _spectral_interval
	from .special import smoothstep
	from .trace import _base_seed, batch_generator

	op = aslinop(A, dtype=torch_dtype(dtype), device=device)
	n = op.shape[0]
	a, b = float(interval[0]), float(interval[1])
	if not a < b:
		raise ValueError(f"interval must satisfy a < b; got {interval}")
	lmin, lmax = spectral_interval if spectral_interval is not None else _spectral_interval(op, seed)
	a, b = max(a, lmin), min(b, lmax)
	if a >= b:
		warnings.warn(
			f"filtered_eigsh: interval {interval} is outside the estimated spectral "
			f"range [{lmin:g}, {lmax:g}]; returning no eigenpairs.",
			stacklevel=2,
		)
		return _empty_slice(op, n)
	f_dtype = torch.promote_types(op.dtype, torch.float32)
	r_dtype = real_dtype(f_dtype)
	tol = max(1e-6, float(np.sqrt(torch.finfo(r_dtype).eps))) if tol is None else float(tol)
	if k is None:
		from .recipes import eigencount

		k = max(int(eigencount(op, (a, b), seed=seed)), 1)
	k = int(min(k, n))
	if k <= 0:
		raise ValueError(f"k must be positive; got k={k}")

	width = 0.02 * (b - a)
	rise, fall = smoothstep(a=a - width, b=a + width), smoothstep(a=b - width, b=b + width)
	if deg is None:
		deg = int(np.clip(8.0 * (lmax - lmin) / max(b - a, 1e-12), 32, 600))
	resolution = (lmax - lmin) / max(int(deg), 1)
	if (b - a) < 0.5 * resolution:
		warnings.warn(
			f"filtered_eigsh: slice width {b - a:.3g} is below the degree-{deg} filter's "
			f"resolution ~{resolution:.3g} (spectral range {lmax - lmin:.3g}); pass a larger "
			"deg= (cost grows linearly) or widen the interval — returning no eigenpairs.",
			stacklevel=2,
		)
		return _empty_slice(op, n)
	rho = ChebyshevFunction(op, fun=lambda x: rise(x) - fall(x), deg=int(deg), interval=(lmin, lmax), damping="jackson")

	s = min(k + (int(oversample) if oversample is not None else max(6, k // 4)), n)
	scale = max(abs(lmin), abs(lmax), 1e-30)
	base = _base_seed(seed)
	X = _gaussian_sketch(batch_generator(base, 0, op.device), (n, s), op.dtype)
	limit = tol * scale

	def iterate(X):
		"""One subspace iteration: ``(X_next, θ, residual norms)``."""
		with full_f32_matmul():
			Q, _ = torch.linalg.qr(rho.matmat(X).to(f_dtype))
			Q = Q.contiguous()  # node-major, as the node-major kernels read it
			W = op.matmat(Q.to(op.dtype)).to(f_dtype)
			theta, U = torch.linalg.eigh(_sym(_h(Q) @ W))
			Xn = Q @ U
			resid = torch.linalg.vector_norm(W @ U - Xn * theta[None, :], dim=0).to(r_dtype)
		return Xn, theta, resid

	def epoch(X, it: int, s: int):
		"""Iterations until convergence, a stall, saturation or ``maxiter``; the stop test is
		read once an iteration (θ and the residuals, ``s`` values each)."""
		theta = np.full(s, a - 1.0)
		resid = np.full(s, np.inf)
		best_acc, best_rem, stall, fresh = -1, np.inf, 0, True
		X = X.to(f_dtype)
		while it < int(maxiter):
			inside = (theta >= a) & (theta <= b)
			n_in = int(np.count_nonzero(inside))
			saturated = n_in >= s - 1 if s < n else False
			converged = n_in > 0 and bool(np.all(np.where(inside, resid, 0.0) <= limit))
			if not (fresh or not (converged or saturated or stall >= 4)):
				break
			X, theta_t, resid_t = iterate(X)
			theta, resid = theta_t.cpu().numpy(), resid_t.cpu().numpy()
			it, fresh = it + 1, False
			inside = (theta >= a) & (theta <= b)
			n_in = int(np.count_nonzero(inside))
			saturated = (n_in >= s - 1) if s < n else False
			if saturated:
				continue  # the host grows the subspace; the counters stay as they were
			acc_mask = inside & (resid <= limit)
			rem_mask = inside & (resid > limit)
			n_acc, n_rem = int(np.count_nonzero(acc_mask)), int(np.count_nonzero(rem_mask))
			cur = float(np.exp(np.mean(np.log(np.maximum(resid[rem_mask], 1e-300))))) if n_rem else np.inf
			improve = n_acc > best_acc or cur < 0.9 * best_rem
			stall = 0 if improve else stall + 1
			best_acc = max(best_acc, n_acc)
			best_rem = best_rem if n_rem == 0 else min(best_rem, cur)
		return it, X, theta, resid

	theta = resid = inside = None
	it, grown = 0, 0
	while it < int(maxiter):
		it, X, theta, resid = epoch(X, it, s)
		inside = (theta >= a) & (theta <= b)
		if int(np.count_nonzero(inside)) >= s - 1 and s < n:
			# The slice fills the subspace (k was short): grow it by fresh directions.
			grow = min(max(s // 2, 4), n - s)
			grown += 1
			X = torch.cat([X, _gaussian_sketch(batch_generator(base, grown, op.device), (n, grow), op.dtype).to(X.dtype)], dim=1)
			s += grow
			continue
		break
	ITERATIONS["filtered_eigsh"] = it
	if inside is None:
		return _empty_slice(op, n)
	if X.shape[1] != inside.shape[0]:  # grown on the last iteration: the new columns saw no Rayleigh-Ritz step
		X = X[:, : inside.shape[0]]
	accept = inside & (resid <= 10.0 * limit)
	n_drop = int(np.count_nonzero(inside & ~accept))
	if n_drop:
		warnings.warn(
			f"filtered_eigsh: dropped {n_drop} unconverged Ritz pair(s) inside "
			f"[{a:g}, {b:g}] (relative residual > {10.0 * tol:g}); if the count "
			"looks short, raise deg/maxiter or widen the interval.",
			stacklevel=2,
		)
	sel = torch.as_tensor(np.flatnonzero(accept), device=X.device)
	w = torch.as_tensor(theta, device=X.device)[sel].to(r_dtype)
	order = torch.argsort(w)
	return w[order], X[:, sel][:, order]


def svds(X, k: int = 6, maxiter: int = 200, tol: Optional[float] = None, return_vectors: bool = True, seed=None,
	dtype=None, device="cuda"):
	"""The top-``k`` singular triplets of a (rectangular) operator (``primate_tpu/eigen.py:568-607``):
	LOBPCG (:func:`eigsh`) on the smaller Gram side, never formed, then ``U = XVΣ⁻¹`` or
	``V = X†UΣ⁻¹``. Returns ``(U, s, Vh)``, ``s`` ascending (scipy's order), or ``s`` alone."""
	from .operators.sparse import GramOperator

	op = aslinop(X, dtype=torch_dtype(dtype), device=device)
	m, n = op.shape
	if not 0 < k < min(m, n):
		raise ValueError(f"k must be in (0, min(m, n)); got k={k}, shape={op.shape}")
	gram = GramOperator(op, transpose_first=(n <= m))
	w, W = eigsh(gram, k=k, which="LA", maxiter=maxiter, tol=tol, seed=seed)
	s = torch.sqrt(torch.clamp(w, min=0.0))
	if not return_vectors:
		return s
	safe = torch.where(s > 0, s, 1.0)[None, :]
	if n <= m:
		V = W
		U = op.matmat(V.to(op.dtype).contiguous()) / safe
	else:
		U = W
		V = op.rmatmat(U.to(op.dtype).contiguous()) / safe
	return U, s, _h(V)


def rsvd(X, k: int = 6, oversample: int = 8, n_iter: int = 2, seed=None, dtype=None, device="cuda"):
	"""A rank-``k`` randomised SVD (Halko-Martinsson-Tropp; ``primate_tpu/eigen.py:622-665``):
	a Gaussian sketch of ``k + oversample`` columns, ``n_iter`` QR-stabilised power
	iterations, the SVD of the small ``Q†X``. ``2·n_iter + 2`` block applies. Returns
	``(U, s, Vh)``, ``s`` descending."""
	from .trace import _base_seed, batch_generator

	op = aslinop(X, dtype=torch_dtype(dtype), device=device)
	m, n = op.shape
	ell = int(min(k + oversample, min(m, n)))
	if not 0 < k <= ell:
		raise ValueError(f"k must be in (0, min(m, n)]; got k={k}, shape={op.shape}")
	Om = _gaussian_sketch(batch_generator(_base_seed(seed), 0, op.device), (n, ell), op.dtype)
	with full_f32_matmul():
		Q, _ = torch.linalg.qr(op.matmat(Om))
		for _ in range(int(n_iter)):
			Z, _ = torch.linalg.qr(op.rmatmat(Q.contiguous()))
			Q, _ = torch.linalg.qr(op.matmat(Z.contiguous()))
		Q = Q.contiguous()
		B = _h(op.rmatmat(Q))  # (ell, n) = Q†X
		Ub, s, Vh = torch.linalg.svd(B, full_matrices=False)
		U = Q @ Ub
	return U[:, :k], s[:k], Vh[:k]


def rand_nystrom(A, rank: int = 6, oversample: int = 8, seed=None, dtype=None, device="cuda"):
	"""A rank-``rank`` randomised Nyström approximation ``Â = U diag(w) U†`` of a PSD operator
	(Tropp-Yurtsever-Udell-Cevher 2017; ``primate_tpu/eigen.py:668-722``): one block apply
	``Y = AΩ`` of an orthonormalised Gaussian sketch, a ν-shifted Cholesky of ``Ω†Y`` (shifted
	again by the core's most negative eigenvalue if the factor is not finite: a numerically
	indefinite input), a thin SVD. Returns ``(w, U)``, ``w`` descending, ``U (n, rank)``
	orthonormal."""
	from .trace import _base_seed, batch_generator

	op = aslinop(A, dtype=torch_dtype(dtype), device=device)
	n = op.shape[0]
	if op.shape[0] != op.shape[1]:
		raise ValueError("rand_nystrom requires a square (PSD) operator")
	ell = int(min(rank + oversample, n))
	if not 0 < rank <= ell:
		raise ValueError(f"rank must be in (0, {ell}]")
	acc = torch.promote_types(op.dtype, torch.float32)
	r_acc = real_dtype(acc)
	eps = torch.finfo(r_acc).eps
	Om = _gaussian_sketch(batch_generator(_base_seed(seed), 0, op.device), (n, ell), op.dtype)
	with full_f32_matmul():
		Om, _ = torch.linalg.qr(Om.to(acc))
		Om = Om.contiguous()
		Y = op.matmat(Om.to(op.dtype)).to(acc)
		nu = eps * torch.linalg.vector_norm(Y) / float(np.sqrt(n))
		Y = Y + nu * Om
		core = 0.5 * ((_h(Om) @ Y) + (_h(Y) @ Om))
		L, info = torch.linalg.cholesky_ex(core)
		if bool(info != 0) or not bool(torch.isfinite(L).all()):  # one read
			w_core = torch.linalg.eigvalsh(core)
			bump = torch.clamp(-w_core[0], min=0.0) * 2.0 + eps * torch.abs(w_core[-1])
			Y = Y + bump * Om
			nu = nu + bump
			core = core + bump * torch.eye(ell, dtype=acc, device=core.device)
			L = torch.linalg.cholesky(core)
		L_inv = torch.linalg.solve_triangular(L, torch.eye(ell, dtype=acc, device=L.device), upper=False)
		B = Y @ _h(L_inv)
		U, s, _ = torch.linalg.svd(B, full_matrices=False)
	w = torch.clamp(s**2 - nu, min=0.0)
	return w[:rank], U[:, :rank]
