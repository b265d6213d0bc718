"""Isotropic probe generation from an explicit ``torch.Generator``.

Counterpart of ``primate_tpu/random.py:37-341``. JAX's stateless threefry keys
become generators on the probes' device; the two packages draw different numbers
from the same seed, so tests hand both the same numpy-made probes. Besides the
probes: the stateful sampler :class:`Isotropic` (column-keyed streams) and the
test matrices :func:`symmetric` and :func:`haar` with a prescribed spectrum.

Probe blocks are ``(n, nv)`` with the probes as columns, as in the JAX package,
but they are drawn probe-major: the returned tensor is the transpose of a
contiguous ``(nv, n)`` block, which the Lanczos sweep then carries without a copy.

Hermitian (complex) operators take real probes unless ``pdf="phase"``: uniform
unit phases ``e^{iθ}``, the complex Rademacher analog, complex dtypes only
(``primate_tpu/random.py:150-156``). :func:`hermitian` is the complex test matrix.
"""

import inspect
import math
from typing import Optional, Union

import numpy as np
import torch

from .linalg import full_f32_matmul

__all__ = ["real_dtype", "classify_pdf", "sample_isotropic", "Isotropic", "isotropic", "symmetric", "haar", "hermitian"]

_ISO_DISTRIBUTIONS = {
	"rademacher": "rademacher",
	"normal": "normal",
	"sphere": "sphere",
	"signs": "rademacher",
	"gaussian": "normal",
	"phase": "phase",  # complex unit phases e^{iθ}: Hermitian operators only
}


def real_dtype(dtype: torch.dtype) -> torch.dtype:
	"""Real counterpart of a floating dtype (``complex64 → float32`` etc.): the dtype of
	the probes and of the estimator state of a Hermitian operator (``primate_tpu/random.py:37-45``)."""
	return dtype.to_real() if dtype.is_complex else dtype


def probe_dtype(dtype: torch.dtype, pdf) -> torch.dtype:
	"""The dtype probes of an operator of ``dtype`` are drawn in: complex for ``pdf="phase"``,
	else real (unbiased for Hermitian operators: ``E[vvᵀ] = I`` and ``v†Av`` is real)."""
	return dtype if isinstance(pdf, str) and pdf == "phase" else real_dtype(dtype)


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
		pdf: one of "rademacher"/"signs", "normal"/"gaussian", "sphere", "phase"
			(complex dtypes only), or a callable ``(generator, shape, dtype) -> tensor``.
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
	if pdf == "phase":
		# Uniform unit phases: E[v v†] = I and every |v_i| = 1, so the Girard
		# variance sees Σ_{i≠j}|A_ij|² (primate_tpu/random.py:150-157).
		if not dtype.is_complex:
			raise ValueError("pdf='phase' needs a complex dtype (Hermitian operators).")
		theta = torch.rand((nv, n), generator=generator, device=device, dtype=real_dtype(dtype)).mul_(2.0 * math.pi)
		return torch.polar(torch.ones_like(theta), theta).T
	if pdf == "rademacher":  # real signs, also in a complex dtype, as jax.random.rademacher draws them
		W = torch.randint(0, 2, (nv, n), generator=generator, device=device, dtype=real_dtype(dtype)).mul_(2).sub_(1)
		return W.to(dtype).T
	W = torch.randn((nv, n), generator=generator, device=device, dtype=dtype)
	if pdf == "sphere":
		# Uniform on the sphere of radius sqrt(n); rows of W are the vectors.
		W.mul_(math.sqrt(n) / torch.linalg.vector_norm(W, dim=1, keepdim=True))
	return W.T


def _generator(seed, stream: int, device) -> torch.Generator:
	from .trace import _base_seed, batch_generator

	return batch_generator(_base_seed(seed), stream, device)


class Isotropic:
	"""Stateful isotropic sampler (``primate_tpu/random.py:171-226``).

	Column ``c`` of the ``counter``-th column drawn so far comes from the generator
	keyed ``(seed, counter)``: the counter advances by the number of columns, so
	150 single-column draws replay one ``(n, 150)`` draw exactly. A draw of more
	than two axes takes one stream for the whole block. ``threads`` is accepted
	for the reference's signature and unused.
	"""

	def __init__(self, size=None, pdf: str = "rademacher", seed=None, dtype=None, threads=None, device="cuda"):
		del threads
		if pdf not in _ISO_DISTRIBUTIONS:
			raise ValueError(f"Invalid distribution '{pdf}' supplied.")
		from .trace import _base_seed

		self.pdf = _ISO_DISTRIBUTIONS[pdf]
		self.seed = _base_seed(seed)
		self.dtype = dtype
		self.shape = size
		self.device = torch.device(device)
		self._counter = 0

	def __call__(self, size=None) -> torch.Tensor:
		size = size if size is not None else self.shape
		if size is None:
			raise ValueError("A sample shape must be provided.")
		shape = (size, 1) if isinstance(size, int) else tuple(size)
		if len(shape) > 2:
			g = _generator(self.seed, self._counter, self.device)
			self._counter += 1
			dtype = self.dtype or torch.get_default_dtype()
			flat = sample_isotropic(g, (shape[0], int(np.prod(shape[1:]))), pdf=self.pdf, dtype=dtype)
			return flat.reshape(shape)
		n, ncols = shape[0], shape[1] if len(shape) == 2 else 1
		base, self._counter = self._counter, self._counter + ncols
		cols = [sample_isotropic(_generator(self.seed, base + c, self.device), (n, 1), pdf=self.pdf, dtype=self.dtype) for c in range(ncols)]
		out = torch.cat(cols, dim=1)
		return out[:, 0] if len(shape) == 1 else out

	def fill(self) -> torch.Tensor:
		"""Sample an array of the configured shape."""
		self.values = self(self.shape)
		return self.values


def isotropic(size=None, pdf: str = "rademacher", seed=None, out: Optional[np.ndarray] = None, device="cuda"):
	"""Isotropic random vectors (``primate_tpu/random.py:229-253``): an array of shape
	``size`` (an int is ``(size, 1)``); with ``size=None`` a sampler ``f(size)``;
	with a numpy ``out``, ``out`` filled in place (drawn in its dtype) and None returned."""
	if out is not None:
		if not isinstance(out, np.ndarray):
			raise TypeError("`out` must be a preallocated numpy array.")
		dtype = torch.from_numpy(np.zeros(0, dtype=out.dtype)).dtype
		out[...] = Isotropic(pdf=pdf, seed=seed, dtype=dtype, device=device)(out.shape).cpu().numpy()
		return None
	sampler = Isotropic(pdf=pdf, seed=seed, device=device)
	return sampler if size is None else sampler(size)


def _orthogonal(g: torch.Generator, n: int, dtype, dist: str = "normal") -> tuple:
	if dist == "uniform":
		M = torch.rand((n, n), generator=g, device=g.device, dtype=dtype)
	elif dist == "normal":
		M = torch.randn((n, n), generator=g, device=g.device, dtype=dtype)
	else:
		raise ValueError(f"Invalid distribution {dist} supplied")
	return torch.linalg.qr(M)


def _spectrum(g: torch.Generator, n: int, ew, lo: float, dtype) -> torch.Tensor:
	if ew is None:
		return torch.rand(n, generator=g, device=g.device, dtype=dtype) * (1.0 - lo) + lo
	return torch.atleast_1d(torch.as_tensor(ew, dtype=dtype, device=g.device))


def symmetric(n: int, dist: str = "normal", pd: bool = False, ew=None, seed=None, dtype=None, device="cuda") -> torch.Tensor:
	"""Random symmetric ``n × n`` matrix with eigenvalues ``ew`` (``primate_tpu/random.py:256-285``):
	``Q diag(ew) Qᵀ`` with ``Q`` the QR factor of a random matrix. Without ``ew`` the
	eigenvalues are uniform in [0, 1] (``pd=True``) or [-1, 1]."""
	dtype = dtype or torch.get_default_dtype()
	Q, _ = _orthogonal(_generator(seed, 0, device), n, dtype, dist)
	ew = _spectrum(_generator(seed, 1, device), n, ew, 0.0 if pd else -1.0, dtype)
	with full_f32_matmul():
		A = (Q * ew[None, :]) @ Q.T
	return (A + A.T) / 2


def haar(n: int, ew=None, seed=None, dtype=None, device="cuda") -> torch.Tensor:
	"""Random matrix ``U diag(ew) Uᵀ`` with ``U`` Haar-distributed on O(n) (QR of a Gaussian
	matrix with Mezzadri's sign correction; ``primate_tpu/random.py:317-341``). Without
	``ew`` the eigenvalues are uniform in [-1, 1]; a shorter ``ew`` is padded with zeros."""
	dtype = dtype or torch.get_default_dtype()
	Q, R = _orthogonal(_generator(seed, 0, device), n, dtype)
	d = torch.sign(torch.diagonal(R))
	U = Q * torch.where(d == 0, 1.0, d)[None, :]
	ew = _spectrum(_generator(seed, 1, device), n, ew, -1.0, dtype)
	ev = torch.zeros(n, dtype=dtype, device=U.device)
	ev[: ew.shape[0]] = ew
	with full_f32_matmul():
		return (U * ev[None, :]) @ U.T


def hermitian(n: int, pd: bool = False, ew=None, seed=None, dtype=None, device="cuda") -> torch.Tensor:
	"""Random complex Hermitian ``n × n`` matrix with real eigenvalues ``ew``
	(``primate_tpu/random.py:288-314``): ``Q diag(ew) Q†`` with ``Q`` the QR factor of a
	complex Gaussian matrix, then ``(A + A†)/2``. Without ``ew`` the eigenvalues are
	uniform in [0, 1] (``pd=True``) or [-1, 1]. ``dtype`` defaults to the complex
	counterpart of torch's default float dtype."""
	if dtype is None:
		dtype = torch.complex128 if torch.get_default_dtype() == torch.float64 else torch.complex64
	r_dtype = real_dtype(dtype)
	g = _generator(seed, 0, device)
	M = torch.complex(torch.randn((n, n), generator=g, device=g.device, dtype=r_dtype),
		torch.randn((n, n), generator=g, device=g.device, dtype=r_dtype))
	Q, _ = torch.linalg.qr(M)
	ew = _spectrum(_generator(seed, 1, device), n, ew, 0.0 if pd else -1.0, r_dtype)
	with full_f32_matmul():
		A = (Q * ew[None, :].to(dtype)) @ Q.mH
	return (A + A.mH) / 2
