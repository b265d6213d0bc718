"""Signature-based kwargs routing (counterpart of ``primate_tpu/utils/kwargs.py``).

Criteria and pdfs named by a string are built from whichever subset of ``**kwargs``
their constructors accept. ``split_kwargs`` partitions a keyword dict by a callable's
signature; a callable that takes ``**kwargs`` receives everything.
"""

from __future__ import annotations

import functools
import inspect
from typing import Any, Callable, Mapping

__all__ = ["split_kwargs", "restrict_kwargs", "setdiff_kwargs"]


@functools.lru_cache(maxsize=256)
def _accepted_names(fun: Callable) -> frozenset | None:
	"""Parameter names ``fun`` accepts by keyword, or ``None`` if it takes ``**kwargs``.

	A callable without an inspectable signature (a builtin, some C callables) accepts nothing.
	"""
	try:
		sig = inspect.signature(fun)
	except (TypeError, ValueError):
		return frozenset()
	names = []
	for p in sig.parameters.values():
		if p.kind is inspect.Parameter.VAR_KEYWORD:
			return None
		if p.kind not in (inspect.Parameter.VAR_POSITIONAL, inspect.Parameter.POSITIONAL_ONLY):
			names.append(p.name)  # positional-only parameters cannot be passed by keyword
	return frozenset(names)


def split_kwargs(fun: Callable, kwargs: Mapping[str, Any]) -> tuple[dict, dict]:
	"""Partition ``kwargs`` into (accepted by ``fun``, everything else)."""
	try:
		names = _accepted_names(fun)
	except TypeError:  # an unhashable callable: probe it without the cache
		names = _accepted_names.__wrapped__(fun)
	if names is None:
		return dict(kwargs), {}
	taken, rest = {}, {}
	for key, val in kwargs.items():
		(taken if key in names else rest)[key] = val
	return taken, rest


def restrict_kwargs(fun: Callable, kwargs: Mapping[str, Any]) -> dict:
	"""The subset of ``kwargs`` that ``fun``'s signature accepts."""
	return split_kwargs(fun, kwargs)[0]


def setdiff_kwargs(f: Callable, kwargs: Mapping[str, Any]) -> dict:
	"""The subset of ``kwargs`` that ``f``'s signature does not accept."""
	return split_kwargs(f, kwargs)[1]
