"""Tracing, apply counting and kernel cost reports (counterpart of ``primate_tpu/utils/profiling.py``).

* ``annotate`` labels a region for ``torch.profiler`` traces (the port's spans:
  ``primate.estimate``, ``primate.sweep``, ``primate.quadrature``);
* ``CountingOperator`` counts an operator's applies (columns, forward and adjoint) and
  their wall time;
* ``kernel_stats`` / ``benchmark_matvec`` give the cost model of one apply (nonzeros,
  flops, bytes) and its measured throughput (nnz/s, matvecs/s, effective GB/s).
"""

import time
from contextlib import nullcontext
from typing import Any, Dict

import torch

from ..operators.base import LinearOperator, aslinop

__all__ = ["annotate", "CountingOperator", "kernel_stats", "benchmark_matvec"]


def annotate(name: str):
	"""Label a region: a ``torch.profiler.record_function`` range while a profiler runs, else a null
	context, so that a span costs one check when nothing traces. Under
	``torch.autograd.profiler.emit_nvtx()`` the profiler counts as running and each range is also an
	NVTX range.

	The port opens three spans on the calling thread, nested: ``primate.estimate`` around each public
	estimator call, ``primate.sweep`` around each Lanczos, Golub-Kahan or Chebyshev recurrence, and
	``primate.quadrature`` around each step from a recurrence's coefficients to the call's numbers."""
	return torch.profiler.record_function(name) if torch.autograd._profiler_enabled() else nullcontext()


class CountingOperator(LinearOperator):
	"""An operator that counts its applies and their wall time (the reference's
	``n_matvecs``/``matvec_time``, ``eigen_operators.h:21,113``).

	``n_matvecs`` adds the columns of every apply (node- or probe-major, forward or
	adjoint); ``matvec_time`` the seconds they took. On the card each apply is
	synchronised, so the time is the device's, and the counter slows a run down: use it
	for accounting, not inside a timed call. A DIA operator's fused Lanczos step kernels
	are not reached through the wrapper: its sweeps take the probe-major stencil.
	"""

	def __init__(self, A, device="cuda"):
		self.A = aslinop(A, device=device)
		self.shape, self.dtype, self.device = self.A.shape, self.A.dtype, self.A.device
		self.n_matvecs = 0
		self.matvec_time = 0.0

	def float_tensors(self) -> tuple:
		return self.A.float_tensors()

	def _timed(self, apply, X: torch.Tensor, cols: int) -> torch.Tensor:
		sync = self.device.type == "cuda"
		if sync:
			torch.cuda.synchronize(self.device)
		t0 = time.perf_counter()
		out = apply(X)
		if sync:
			torch.cuda.synchronize(self.device)
		self.matvec_time += time.perf_counter() - t0
		self.n_matvecs += int(cols)
		return out

	def _matmat(self, V: torch.Tensor) -> torch.Tensor:
		return self._timed(self.A.matmat, V, V.shape[1] if V.ndim == 2 else 1)

	def matmat_t(self, Vt: torch.Tensor) -> torch.Tensor:
		return self._timed(self.A.matmat_t, Vt, Vt.shape[0])

	def rmatmat(self, V: torch.Tensor) -> torch.Tensor:
		return self._timed(self.A.rmatmat, V, V.shape[1])

	def rmatvec(self, v: torch.Tensor) -> torch.Tensor:
		return self._timed(self.A.rmatvec, v, 1)

	def rmatmat_t(self, Ut: torch.Tensor) -> torch.Tensor:
		return self._timed(self.A.rmatmat_t, Ut, Ut.shape[0])


def kernel_stats(A) -> Dict[str, Any]:
	"""Static cost model of one matvec: ``shape``, ``dtype`` (its numpy name), ``nnz`` and,
	where it is known, ``flops_per_matvec`` and ``bytes_per_matvec``."""
	op = A if isinstance(A, LinearOperator) else aslinop(A)
	n, m = op.shape
	itemsize = torch.empty(0, dtype=op.dtype).element_size()
	nnz = getattr(op, "nnz", None)
	if nnz is None:
		nnz = n * m if isinstance(getattr(op, "A", None), torch.Tensor) else None
	stats = {"shape": tuple(op.shape), "dtype": str(op.dtype).replace("torch.", ""), "nnz": nnz}
	if nnz is not None:
		stats["flops_per_matvec"] = 2 * nnz
		stats["bytes_per_matvec"] = nnz * itemsize + 2 * n * itemsize
	return stats


def benchmark_matvec(A, k: int = 32, iters: int = 20, seed: int = 0, warmup: int = 2) -> Dict[str, float]:
	"""Measured throughput of the operator's apply on ``k`` probes.

	Chains ``iters`` dependent applies, each normalising its output's rows, on a
	probe-major ``(k, n)`` block (the estimators' layout) after ``warmup`` such chains,
	and reports seconds per apply (``sec_per_matmat``), ``matvecs_per_s`` and, where the
	operator knows its nonzeros, ``nnz_per_s`` and ``effective_GBps``. On the card the
	chain is timed by CUDA events, elsewhere by the host clock.
	"""
	op = A if isinstance(A, LinearOperator) else aslinop(A)
	n = op.shape[1]
	gen = torch.Generator(device=op.device)
	gen.manual_seed(int(seed))
	real = op.dtype.to_real() if op.dtype.is_complex else op.dtype
	Vt = torch.randn((k, n), generator=gen, dtype=torch.promote_types(real, torch.float32), device=op.device).to(op.dtype)

	def chain(Xt):
		for _ in range(iters):
			Yt = op.matmat_t(Xt)
			Xt = Yt / torch.linalg.vector_norm(Yt, dim=1, keepdim=True)
		return Xt

	for _ in range(warmup):
		chain(Vt)
	if op.device.type == "cuda":
		start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
		torch.cuda.synchronize(op.device)
		start.record()
		chain(Vt)
		end.record()
		torch.cuda.synchronize(op.device)
		dt = start.elapsed_time(end) / 1e3 / iters
	else:
		t0 = time.perf_counter()
		chain(Vt)
		dt = (time.perf_counter() - t0) / iters

	out: Dict[str, float] = {"sec_per_matmat": dt, "matvecs_per_s": k / dt}
	stats = kernel_stats(op)
	if stats.get("nnz"):
		itemsize = torch.empty(0, dtype=op.dtype).element_size()
		out["nnz_per_s"] = stats["nnz"] / dt
		out["effective_GBps"] = (stats["nnz"] + 2 * n * k) * itemsize / dt / 1e9
	return out
