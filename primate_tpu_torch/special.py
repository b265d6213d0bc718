"""Spectral function gallery: builtin ``f`` for matrix functions ``f(A)``.

Counterpart of ``primate_tpu/special.py``. Every builtin maps a tensor of
quadrature nodes to a tensor, on the nodes' device. A stacked family
(:func:`stacked`) maps them to a tensor with one more leading axis. As in the
JAX package, ``softsign``, ``smoothstep``, ``exp`` and ``step`` take the nodes
first: given them they return values, without them the function.
"""

from functools import lru_cache
from math import comb
from typing import Any, Callable, Union

import numpy as np
import torch

__all__ = ["param_callable", "stacked", "softsign", "smoothstep", "exp", "step", "identity", "BUILTIN_MATRIX_FUNCTIONS"]

BUILTIN_MATRIX_FUNCTIONS = ["identity", "abs", "sqrt", "log", "inv", "exp", "smoothstep", "numrank", "softsign"]


def identity(x: Any) -> Any:
	return x


def _nodes(x, device) -> torch.Tensor:
	"""``x`` as a tensor: a tensor keeps its device and dtype; a number or array goes through
	numpy (a Python float is float64, an integer array becomes float64) onto ``device``."""
	if isinstance(x, torch.Tensor):
		return x
	x = np.asarray(x)
	return torch.as_tensor(x if x.dtype.kind in "fc" else x.astype(np.float64), device=device)


def softsign(x=None, q: int = 1, *, device="cuda") -> Union[Callable, torch.Tensor]:
	"""Degree-``q`` polynomial approximant to sign(x) on [-1, 1]: its values at the nodes ``x``,
	or without them the function itself (``primate_tpu/special.py:36-53``)."""
	J = np.append([1.0], np.cumprod([(2 * j - 1) / (2 * j) for j in np.arange(1, q + 1)]))

	def _softsign(x):
		xt = torch.atleast_1d(torch.clamp(x, -1.0, 1.0))[..., None]
		Ic = torch.arange(q + 1, device=xt.device, dtype=xt.dtype)
		Jc = torch.as_tensor(J, device=xt.device, dtype=xt.dtype)
		return torch.sum(xt * (1 - xt**2) ** Ic * Jc, dim=-1)

	return _softsign if x is None else _softsign(_nodes(x, device))


def smoothstep(x=None, a: float = 0.0, b: float = 1.0, deg: int = 3, *, device="cuda") -> Union[Callable, torch.Tensor]:
	"""Polynomial Hermite step of odd degree ``deg``, 0 below ``a`` and 1 above ``b``: its values
	at the nodes ``x``, or without them the function itself (``primate_tpu/special.py:56-81``)."""
	if deg % 2 != 1:
		raise ValueError("Degree must be odd")
	d = (b - a) if a != b else 1.0
	N = (int(deg) - 1) // 2
	coefs = [comb(N + k, k) * comb(2 * N + 1, N - k) * ((-1.0) ** k) for k in range(N + 1)]

	def _smoothstep(x):
		y = torch.clamp((x - a) / d, 0.0, 1.0)
		acc = torch.zeros_like(y)
		for c in reversed(coefs):  # Horner in y, then × y^{N+1}
			acc = acc * y + c
		return acc * y ** (N + 1)

	return _smoothstep if x is None else _smoothstep(_nodes(x, device))


def exp(x=None, t: float = 1.0, *, device="cuda") -> Union[Callable, torch.Tensor]:
	"""Exponential ``x ↦ exp(t·x)``: its values at the nodes ``x``, or without them the function."""

	def _exp(x):
		return torch.exp(t * x)

	return _exp if x is None else _exp(_nodes(x, device))


def step(x=None, c: float = 0.0, nonnegative: bool = False, *, device="cuda") -> Union[Callable, torch.Tensor]:
	"""Hard threshold ``x ↦ 1[x ≥ c]`` (optionally on |x|): its values at the nodes ``x``, or
	without them the function."""

	def _step(x):
		x = torch.abs(x) if nonnegative else x
		return torch.where(x < c, 0.0, 1.0).to(x.dtype)

	return _step if x is None else _step(_nodes(x, device))


def _log_eps(x):
	# Clamp at machine eps so logdet-style quadratures never see log(<=0).
	return torch.log(torch.clamp(x, min=torch.finfo(x.dtype).eps))


@lru_cache(maxsize=256)
def _cached_builtin(fun: str, kwargs_items: tuple) -> Callable:
	kwargs = dict(kwargs_items)
	if fun == "abs":
		return torch.abs
	if fun == "sqrt":
		return torch.sqrt
	if fun == "log":
		return _log_eps
	if fun == "inv":
		return torch.reciprocal
	if fun == "exp":
		return exp(t=kwargs.pop("t", 1.0))
	if fun == "smoothstep":
		return smoothstep(a=kwargs.pop("a", 0.0), b=kwargs.pop("b", 1.0), deg=kwargs.pop("deg", 3))
	if fun == "softsign":
		return softsign(q=kwargs.pop("q", 10))
	if fun == "numrank":
		return step(c=kwargs.pop("threshold", 1e-6), nonnegative=True)
	raise ValueError(f"Unknown function: {fun}.")


@lru_cache(maxsize=256)
def _cached_stacked(fun: str, param: str, values: tuple, kwargs_items: tuple) -> Callable:
	fs = [param_callable(fun, **{param: v}, **dict(kwargs_items)) for v in values]

	def _stacked(x):
		return torch.stack([f(x) for f in fs])

	_stacked.nout = len(fs)
	return _stacked


def stacked(fun: Union[str, Callable], values, param: str = "t", **kwargs) -> Callable:
	"""A family of spectral functions as one callable (``primate_tpu/special.py:142-172``):
	``stacked(fun, values)(x)[i] == fun(x, param=values[i])``, with one leading
	axis of length ``len(values)`` (its ``nout``).

	``MatrixFunction.quad``/``matvec``, :func:`~primate_tpu_torch.hutch` and
	:func:`~primate_tpu_torch.diag` evaluate the whole family from one Lanczos sweep
	per probe block. ``fun`` is a builtin name (the value goes in as ``param``) or a
	callable ``(x, value)``; ``kwargs`` are fixed across the family. Builtin
	families are memoised on their arguments.
	"""
	vals = tuple(float(v) for v in np.atleast_1d(np.asarray(values)).ravel())
	if isinstance(fun, str):
		return _cached_stacked(fun, param, vals, tuple(sorted(kwargs.items())))
	if not callable(fun):
		raise TypeError("Matrix function must be a string or callable.")

	def _stacked(x):
		return torch.stack([fun(x, v) for v in vals])

	_stacked.nout = len(vals)
	return _stacked


def param_callable(fun: Union[str, Callable, None], **kwargs) -> Callable:
	"""Resolve a builtin function name (or pass a callable through) to a tensor function.

	Builtins are memoized on (name, params), as in the JAX package.
	"""
	if fun is None or fun == "identity":
		return identity
	if callable(fun):
		return fun
	if not isinstance(fun, str):
		raise TypeError("Matrix function must be a string or callable.")
	known = {"t", "a", "b", "q", "threshold", "deg"}
	items = tuple(sorted((k, v) for k, v in kwargs.items() if k in known))
	return _cached_builtin(fun.lower(), items)
