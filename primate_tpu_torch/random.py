"""Isotropic probe generation from an explicit ``torch.Generator``.

Counterpart of ``primate_tpu/random.py:37-168``. JAX's stateless threefry keys
become generators on the probes' device; the two packages draw different numbers
from the same seed, so tests hand both the same numpy-made probes.

Probe blocks are ``(n, nv)`` with the probes as columns, as in the JAX package,
but they are drawn probe-major: the returned tensor is the transpose of a
contiguous ``(nv, n)`` block, which the Lanczos sweep then carries without a copy.
"""

import inspect
import math
from typing import Optional, Union

import torch

__all__ = ["real_dtype", "classify_pdf", "sample_isotropic"]

_ISO_DISTRIBUTIONS = {
	"rademacher": "rademacher",
	"normal": "normal",
	"sphere": "sphere",
	"signs": "rademacher",
	"gaussian": "normal",
}


def real_dtype(dtype: torch.dtype) -> torch.dtype:
	"""Real counterpart of a floating dtype (``complex64 → float32`` etc.)."""
	return dtype.to_real() if dtype.is_complex else dtype


def classify_pdf(pdf) -> str:
	"""Classify a ``pdf`` argument: "string" | "key" | "size".

	"key" is a callable ``(generator, shape, dtype) -> tensor``; "size" a
	numpy-style host sampler ``pdf(size=...)`` (the reference's convention).
	"""
	if isinstance(pdf, str):
		return "string"
	if not callable(pdf):
		raise TypeError(f"pdf must be a distribution name or a callable; got {type(pdf)}")
	try:
		params = inspect.signature(pdf).parameters
	except (TypeError, ValueError):
		# Uninspectable callables are in practice numpy-style samplers.
		return "size"
	return "size" if "size" in params else "key"


def sample_isotropic(
	generator: torch.Generator,
	shape: Union[int, tuple],
	pdf: str = "rademacher",
	dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
	"""Draw isotropic random vectors (columns) on ``generator.device``.

	Parameters:
		generator: the source of randomness; its device is the probes' device.
		shape: ``(n, nv)``; an int ``n`` is promoted to ``(n, 1)``.
		pdf: one of "rademacher"/"signs", "normal"/"gaussian", "sphere", or a
			callable ``(generator, shape, dtype) -> tensor``.
		dtype: element type (defaults to torch's default float dtype).

	Returns:
		An ``(n, nv)`` tensor, probe-major in memory, whose columns satisfy ``E[v vᵀ] = I``.
	"""
	shape = (shape, 1) if isinstance(shape, int) else tuple(shape)
	dtype = dtype or torch.get_default_dtype()
	if callable(pdf):
		out = torch.as_tensor(pdf(generator, shape, dtype))
		if tuple(out.shape) != shape:
			raise ValueError(f"custom pdf returned shape {tuple(out.shape)}, expected {shape}")
		return out
	if pdf not in _ISO_DISTRIBUTIONS:
		raise ValueError(f"Invalid distribution '{pdf}' supplied.")
	pdf = _ISO_DISTRIBUTIONS[pdf]
	if len(shape) != 2:
		raise ValueError(f"probe blocks are (n, nv); got shape {shape}")
	n, nv = shape
	device = generator.device
	if pdf == "rademacher":
		W = torch.randint(0, 2, (nv, n), generator=generator, device=device, dtype=dtype).mul_(2).sub_(1)
		return W.T
	W = torch.randn((nv, n), generator=generator, device=device, dtype=dtype)
	if pdf == "sphere":
		# Uniform on the sphere of radius sqrt(n); rows of W are the vectors.
		W.mul_(math.sqrt(n) / torch.linalg.vector_norm(W, dim=1, keepdim=True))
	return W.T
