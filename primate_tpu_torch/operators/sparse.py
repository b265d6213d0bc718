"""Banded (DIA) operator on torch tensors.

Counterpart of ``DIAOperator`` in ``primate_tpu/operators/sparse.py:697-911``.
Row-aligned convention: ``bands[d, i] = A[i, i + offsets[d]]``, so
``(A x)[i] = Σ_d bands[d, i]·x[i + offsets[d]]``. The probe-major apply and the
Lanczos step run the CUDA kernels of :mod:`primate_tpu_torch.ops.dia` on the
card. The TPU's halo-padded carry (``phys_spec``/``matmat_t_phys``) has no
counterpart: the kernels bounds-check the edges instead.
"""

from typing import Tuple

import numpy as np
import torch

from ..ops.dia import dia_stencil_t, lanczos_dia_step
from .base import LinearOperator

__all__ = ["DIAOperator"]


class DIAOperator(LinearOperator):
	"""Diagonal/banded operator: one length-n band per nonzero diagonal."""

	def __init__(self, bands: torch.Tensor, offsets: Tuple[int, ...], shape: Tuple[int, int]):
		self.bands = bands.contiguous()  # (n_diags, n)
		self.offsets = tuple(int(o) for o in offsets)
		self.shape = tuple(int(s) for s in shape)
		if self.bands.shape != (len(self.offsets), self.shape[0]):
			raise ValueError(f"bands {tuple(self.bands.shape)} do not match {len(self.offsets)} offsets and n={self.shape[0]}")
		self.dtype = self.bands.dtype
		self.device = self.bands.device
		# The kernels read the offsets from device memory; upload them once.
		self.offsets_t = torch.tensor(self.offsets, dtype=torch.int64, device=self.device)

	@classmethod
	def from_numpy(cls, bands, offsets, shape, *, dtype=None, device="cpu") -> "DIAOperator":
		"""From row-aligned numpy bands ``(n_diags, n)`` (e.g. ``np.asarray(jax_op.bands)``)."""
		return cls(torch.tensor(np.asarray(bands), dtype=dtype, device=device), offsets, shape)

	@classmethod
	def from_scipy(cls, A, dtype=None, device="cpu") -> "DIAOperator":
		"""From a scipy sparse matrix, through ``A.todia()`` (``primate_tpu/operators/sparse.py:731-745``)."""
		A = A.todia()
		n = A.shape[0]
		offsets = tuple(int(o) for o in A.offsets)
		# scipy stores column-aligned (data[k][j] = A[j-off, j]); shift to
		# row-aligned and zero the out-of-range tail of each band.
		bands = np.zeros((len(offsets), n), A.data.dtype)
		for k, off in enumerate(offsets):
			src = A.data[k]
			if off >= 0:
				m = n - off
				bands[k, :m] = src[off : off + m]
			else:
				m = n + off
				bands[k, -off : -off + m] = src[:m]
		return cls.from_numpy(bands, offsets, A.shape, dtype=dtype, device=device)

	@property
	def nnz(self) -> int:
		return self.bands.numel()

	def matmat_t(self, Vt: torch.Tensor) -> torch.Tensor:
		"""Probe-major stencil ``out[b, i] = Σ_d band_d[i]·Vt[b, i + off_d]`` (kernel A on the card)."""
		Vt = torch.as_tensor(Vt, dtype=self.dtype, device=self.device).contiguous()
		return dia_stencil_t(self.bands, self.offsets_t, Vt)

	def _matmat(self, V: torch.Tensor) -> torch.Tensor:
		# Node-major blocks route through the probe-major stencil with a
		# transpose; the node-major TPU kernel (`dia_matmat_pallas`) is not ported.
		return self.matmat_t(V.T).T

	def matvec(self, v: torch.Tensor) -> torch.Tensor:
		v = torch.as_tensor(v, device=self.device)
		if v.ndim != 1:
			return self._matmat(v)
		return self.matmat_t(v[None, :])[0]

	def rmatvec(self, v: torch.Tensor) -> torch.Tensor:
		# Adjoint A†: band'_{-d}[i] = conj(band_d[i - d]).
		n = self.shape[0]
		v = torch.as_tensor(v, device=self.device)
		acc = torch.promote_types(self.dtype, torch.float32)
		out = torch.zeros(n, dtype=acc, device=self.device)
		for k, off in enumerate(self.offsets):
			lo, hi = max(0, -off), min(n, n - off)
			if lo < hi:
				out[lo + off : hi + off] += self.bands[k, lo:hi].conj().to(acc) * v[lo:hi].to(acc)
		return out.to(self.dtype)

	def todense(self) -> torch.Tensor:
		n = self.shape[0]
		out = torch.zeros(self.shape, dtype=self.dtype, device=self.device)
		idx = torch.arange(n, device=self.device)
		for k, off in enumerate(self.offsets):
			valid = (idx + off >= 0) & (idx + off < n)
			out[idx[valid], idx[valid] + off] += self.bands[k][valid]
		return out

	def lanczos_step(
		self, q_cur: torch.Tensor, q_prev: torch.Tensor, beta: torch.Tensor
	) -> Tuple[torch.Tensor, torch.Tensor]:
		"""Fused step ``v = A·q_cur − β·q_prev``, ``α = Σ v·q_cur`` (kernel B on the card)."""
		return lanczos_dia_step(self.bands, self.offsets_t, q_cur, q_prev, beta)
