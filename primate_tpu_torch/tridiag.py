"""Batched symmetric tridiagonal eigensolves.

Counterpart of ``primate_tpu/tridiag.py:48-239``. The Jacobi matrices of a
Lanczos sweep are small (deg × deg) and come in batches of nv probes, so the
default (``method="auto"``/``"eigh"``/``"mrrr"``) densifies each and hands the
batch to ``torch.linalg.eigh``, as the JAX package leaves it to
``jnp.linalg.eigh``. ``method="tqli"`` runs the implicit-shift QL solver
instead: the reference's Pythran ``tqli`` is host code, and so is this one, a
scalar loop per matrix in float64 whose result goes back to the input's device.
"""

import math
import warnings
from typing import Tuple, Union

import numpy as np
import torch

__all__ = ["tridiag_matrix", "eigh_tridiag", "eigvalsh_tridiag", "sign", "tqli"]


def sign(a, b):
	"""Transfer of sign: ``|a|`` carrying the sign of ``b`` (Fortran ``SIGN``), elementwise, ``b == 0``
	counted as positive (``primate_tpu/tridiag.py:27-37``, which fixes the reference helper's
	``b > 1`` comparison)."""
	a, b = torch.as_tensor(a), torch.as_tensor(b)
	return torch.where(b >= 0, torch.abs(a), -torch.abs(a))


_METHODS = ("auto", "eigh", "mrrr", "tqli")


def _normalize_offdiag(d: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
	"""The length ``deg-1`` off-diagonal; also accepts a length-deg ``e`` with a leading zero."""
	if e.shape[-1] == d.shape[-1]:
		return e[..., 1:]
	if e.shape[-1] != d.shape[-1] - 1:
		raise ValueError("Invalid diagonal/subdiagonal pair")
	return e


def tridiag_matrix(d: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
	"""Densify ``d (..., deg)`` and off-diagonals ``e`` into ``(..., deg, deg)`` symmetric tridiagonals."""
	e = _normalize_offdiag(d, e)
	return torch.diag_embed(d) + torch.diag_embed(e, offset=1) + torch.diag_embed(e, offset=-1)


def _check_method(method: str) -> None:
	if method not in _METHODS:
		raise ValueError(f"method must be one of {_METHODS}, got {method!r}")


def eigh_tridiag(d: torch.Tensor, e: torch.Tensor, method: str = "auto", maxiter: int = 30) -> Tuple[torch.Tensor, torch.Tensor]:
	"""Eigenpairs ``(rw (..., deg), Y (..., deg, deg))`` of the tridiagonals ``T(d, e)``, batched."""
	_check_method(method)
	if method == "tqli":
		return tqli(d, e, eigenvectors=True, maxiter=maxiter)
	return torch.linalg.eigh(tridiag_matrix(d, e))


def eigvalsh_tridiag(d: torch.Tensor, e: torch.Tensor, method: str = "auto", maxiter: int = 30) -> torch.Tensor:
	"""Eigenvalues of the tridiagonals ``T(d, e)``, batched."""
	_check_method(method)
	if method == "tqli":
		return tqli(d, e, eigenvectors=False, maxiter=maxiter)
	return torch.linalg.eigvalsh(tridiag_matrix(d, e))


def _tqli_single(d: list, e: list, want_vecs: bool, maxiter: int):
	"""Implicit-shift QL with Givens rotations on one tridiagonal, in place on the
	float lists ``d`` (n) and ``e`` (n, ``e[i]`` couples rows i and i+1, ``e[n-1] = 0``).

	The same sweep, split test and underflow exit as the JAX ``_tqli_single``
	(``primate_tpu/tridiag.py:84-179``). Returns ``(Z or None, converged)``."""
	n = len(d)
	Z = np.eye(n) if want_vecs else None

	def find_split(l: int) -> int:
		for m in range(l, n - 1):
			dd = abs(d[m]) + abs(d[m + 1])
			if abs(e[m]) + dd == dd:
				return m
		return n - 1

	for l in range(n - 1):
		it = 0
		while it < maxiter and e[l] != 0.0:
			m = find_split(l)
			if m == l:
				break
			g = (d[l + 1] - d[l]) / (2.0 * e[l])
			r = math.hypot(g, 1.0)
			g = d[m] - d[l] + e[l] / (g + (r if g >= 0 else -r))
			s, c, p, alive = 1.0, 1.0, 0.0, True
			for i in range(m - 1, l - 1, -1):
				f, b = s * e[i], c * e[i]
				r = math.hypot(f, g)
				underflow = r == 0.0 and i < m - 1
				e[i + 1] = r
				safe_r = 1.0 if r == 0.0 else r
				s_n, c_n = f / safe_r, g / safe_r
				g_n = d[i + 1] - p
				r2 = (d[i] - g_n) * s_n + 2.0 * c_n * b
				p_n = s_n * r2
				if underflow:
					# e[i+1] = 0 splits the block, so the next sweep converges.
					d[i + 1] = d[i + 1] - p
					alive = False
					break
				d[i + 1] = g_n + p_n
				if Z is not None:
					col_i, col_i1 = Z[:, i].copy(), Z[:, i + 1].copy()
					Z[:, i + 1] = s_n * col_i + c_n * col_i1
					Z[:, i] = c_n * col_i - s_n * col_i1
				s, c, p, g = s_n, c_n, p_n, c_n * r2 - b
			if alive:
				d[l] = d[l] - p
				e[l] = g
			e[m] = 0.0
			it += 1
	# Converged: every off-diagonal within a few ulps of its rows. (JAX's exact
	# split test, re-run on the final values, flips on round-off: a later block's
	# shift moves d[l+1] after e[l] passed it.)
	eps = np.finfo(np.float64).eps
	ok = all(abs(e[i]) <= 4 * eps * (abs(d[i]) + abs(d[i + 1])) for i in range(n - 1))
	return Z, ok


def tqli(
	d: torch.Tensor, e: torch.Tensor, eigenvectors=False, maxiter: int = 30, max_iter=None, Z=None
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
	"""Tridiagonal QL-implicit eigensolver, batched over leading axes (``primate_tpu/tridiag.py:182-239``).

	Returns the eigenvalues in the order the shifts leave them (unsorted), or
	``(rw, Z)`` with the eigenvectors as columns, in ``promote_types(d.dtype,
	float32)`` on ``d``'s device. ``max_iter`` is the reference's name for
	``maxiter``. Warns when a block is not converged after ``maxiter`` sweeps.

	The reference's signature ``tqli(d, e, Z, max_iter)`` passes an output array as the
	third argument (or as ``Z``): an array there selects that convention. Eigenvectors are
	computed when it is not empty; the eigenvalues are written back into a numpy ``d`` and
	the eigenvectors (from the identity) into a numpy ``Z`` of the right shape, and the
	result is returned as well.
	"""
	if max_iter is not None:
		maxiter = int(max_iter)
	if Z is not None:  # keyword form of the reference's output-array argument
		eigenvectors = Z
	out_arrays = not (isinstance(eigenvectors, (bool, np.bool_)) or eigenvectors is None)
	d_in, Z_out = d, None
	if out_arrays:
		want_vecs = int(np.prod(np.shape(eigenvectors))) > 0
		Z_out = eigenvectors if (want_vecs and isinstance(eigenvectors, np.ndarray)) else None
		eigenvectors = want_vecs
	result = _tqli(d, e, bool(eigenvectors), maxiter)
	if out_arrays:
		rw = result[0] if eigenvectors else result
		if isinstance(d_in, np.ndarray) and d_in.shape == tuple(rw.shape):
			d_in[...] = rw.cpu().numpy()
		if Z_out is not None and Z_out.shape == tuple(result[1].shape):
			Z_out[...] = result[1].cpu().numpy()
	return result


def _tqli(d, e, eigenvectors: bool, maxiter: int):
	d, e = torch.as_tensor(d), torch.as_tensor(e)
	e = _normalize_offdiag(d, e)
	acc = torch.promote_types(d.dtype, torch.float32)
	dn = d.detach().to("cpu", torch.float64).numpy().reshape(-1, d.shape[-1])
	en = e.detach().to("cpu", torch.float64).numpy().reshape(-1, max(d.shape[-1] - 1, 0))
	n = dn.shape[1]
	rw = np.empty_like(dn)
	Zs = np.empty((dn.shape[0], n, n)) if eigenvectors else None
	converged = True
	for k in range(dn.shape[0]):
		dk, ek = dn[k].tolist(), en[k].tolist() + [0.0]
		Z, ok = _tqli_single(dk, ek, bool(eigenvectors), int(maxiter))
		rw[k] = dk
		if eigenvectors:
			Zs[k] = Z
		converged &= ok
	if not converged:
		warnings.warn(
			f"tqli: not all off-diagonals became negligible within maxiter={maxiter} "
			"QL sweeps; returned eigenvalues may be partially converged (raise maxiter).",
			stacklevel=3,
		)
	out = torch.from_numpy(rw.reshape(d.shape)).to(d.device, acc)
	if not eigenvectors:
		return out
	return out, torch.from_numpy(Zs.reshape(d.shape + (n,))).to(d.device, acc)
