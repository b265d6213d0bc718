"""Row/block-partitioned operators over a device mesh (``primate_tpu/parallel/sharded.py``).

Each rank holds one contiguous block of the operator's rows (``ceil(n / n_op)`` rows, the last
block padded with zero rows) as an unsharded operator of this package, :attr:`local`, whose
applies run the kernels: ``dia_stencil_t``/``dia_stencil`` for DIA, ``bsr_spmm`` for BSR (in
place of ``_local_bsr_mm``'s Pallas call), one cuSPARSE SpMM for CSR (the JAX package's XLA
gathers), ``torch.matmul`` for dense. Communication is ``comm="allgather"`` (the rank's rows
against the whole block) or ``comm="halo"`` (its rows plus the ``h`` rows on each side, valid
when every stored entry lies within the neighbouring ranks' rows; ``"auto"`` tests the pattern).

JAX runs its estimators unchanged on sharded operators because GSPMD turns every sum over n into
a ``psum`` (``primate_tpu/parallel/sharded.py:24-28``). Here a sharded operator has two faces:

* **the global face**, the :class:`~primate_tpu_torch.operators.base.LinearOperator` contract:
  ``matmat``/``matmat_t``/``matvec`` take a block that every rank holds whole and identical, and
  return the whole product on every rank. Each rank cuts the rows it reads from the replicated
  input (its rows and the halo, so no input is exchanged), applies :attr:`local`, and all-gathers
  the output rows (with a probe axis, ranks of different probe groups take different columns and
  gather over the probe group too). Every estimator, sketch, eigensolver, KPM and CG runs on it
  unchanged on every rank; with the same seed, every rank draws the same probes and reaches the
  same estimate.
* **the local face**, the Lanczos sweep's row-sharded carry (:meth:`sweep_rows`): the sweep carries
  only the rank's rows (and its probe slice), in a buffer with ``h`` halo columns each side that
  :func:`~primate_tpu_torch.parallel._comm.halo_exchange` fills in place, so the stencil reads it
  without a concatenate. Every sum over n in the sweep is finished by an all-reduce over the op
  group; α, β and the Gauss rules are then identical on every rank. The DIA operator's carry is the
  padded one of the step kernels (``lo`` and ``ld`` whole 128-byte lines), and its steps run them:
  passes A and B with their sums all-reduced between them, each step's finish left pending and run
  by the next step's pass A (float32/float64) or B2 (bfloat16); ``lanczos_dia_advance``
  (:meth:`lanczos_sweep_flush`) runs a pending finish where the sweep reads its state: after the last
  step, so once an SLQ sweep, and before each coefficient or basis write of a sweep that keeps them.
  The BSR, CSR and dense operators run the plain step's PyTorch arithmetic around their applies.

Not ported (TPU only): ``_local_bsr_mm``'s 128-lane probe padding and the GSPMD row padding of the
dense operator to a device multiple; the stacked per-device arrays, their padding to a common
length and the zero tiles that cover empty block rows (the kernels walk ``indptr``).
"""

from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..operators.base import DenseOperator, LinearOperator, torch_dtype
from ..operators.sparse import BSROperator, CSROperator, DIAOperator
from ..ops.dia import (
	CarrySpec, carry_spec, lanczos_dia_finish, lanczos_dia_round_step, lanczos_dia_step, lanczos_dia_sweep_step,
	lanczos_sweep_step_ref, row_dot,
)
from ._comm import all_gather_rows, all_reduce_rows, halo_exchange

__all__ = ["ShardedCSROperator", "ShardedDenseOperator", "ShardedBSROperator", "ShardedDIAOperator", "shard_operator"]


def _axis_size(mesh, axis: Optional[str]) -> int:
	return 1 if axis is None else mesh.size(mesh.mesh_dim_names.index(axis))


def _local_rank(mesh, axis: str) -> int:
	"""This rank's coordinate along ``axis``; a rank outside the mesh holds no block."""
	if mesh.get_coordinate() is None:
		raise ValueError("this rank is not part of the mesh")
	return mesh.get_local_rank(axis)


def _device_of(A, device):
	return device if device is not None else (A.device if isinstance(A, LinearOperator) else "cuda")


class _SweepRows:
	"""The local face of a sharded operator in the Lanczos sweep: the rank's rows (and, with a probe
	axis, its probe slice ``cols``) of every carried block; each sum over n finished over the op group."""

	def __init__(self, op: "_Sharded", cols: Optional[slice]):
		self.op, self.cols = op, cols

	def carry(self, Xt: torch.Tensor) -> torch.Tensor:
		"""The carry of a replicated probe-major block ``(nv, n)``: its rows and halo, its probe slice."""
		return self.op._own_rows(Xt if self.cols is None else Xt[self.cols], 1)

	def rows(self, X: torch.Tensor) -> torch.Tensor:
		return self.op._rows(X)

	def reduce_rows(self, t: torch.Tensor) -> torch.Tensor:
		return self.op._reduce(t)

	def probes(self, c: torch.Tensor) -> torch.Tensor:
		"""The rank's slice of per-probe values ``(..., nv)``."""
		return c if self.cols is None else c[..., self.cols]

	def gather_probes(self, t: torch.Tensor) -> torch.Tensor:
		if self.cols is None:
			return t
		return all_gather_rows(t, t.shape[-1] * dist.get_world_size(self.op.probe_group), self.op.probe_group, -1)

	def gather_rows(self, X: torch.Tensor) -> torch.Tensor:
		"""A block ``(..., nv_rank, rows)`` of the rank's rows → the whole ``(..., nv, n)`` on every rank."""
		Y = all_gather_rows(X, self.op.shape[0], self.op.op_group, -1)
		if self.cols is None:
			return Y
		return all_gather_rows(Y, Y.shape[-2] * dist.get_world_size(self.op.probe_group), self.op.probe_group, -2)


class _Sharded(LinearOperator):
	"""What the sharded operators share: the mesh's groups, the row chunking, the global face and the
	local face (see the module docstring). ``local`` maps the rank's input window to its output
	rows; ``_h`` is the halo width in rows (0 for ``comm="allgather"``)."""

	def _setup(
		self, local: LinearOperator, shape, mesh, op_axis: str, probe_axis: Optional[str], comm: str, rows: int, h: int,
		spec: Optional[CarrySpec] = None,
	):
		"""``spec``: the rank's carry and window, ``(width, lead, rows)`` (default ``h`` columns on each
		side of the rows, ``(rows + 2h, h, rows)``)."""
		self.local = local
		self.shape = tuple(int(s) for s in shape)
		self.dtype, self.device = local.dtype, local.device
		self.mesh, self.op_axis, self.probe_axis, self.comm = mesh, op_axis, probe_axis, comm
		self.op_group = mesh.get_group(op_axis)
		self.probe_group = mesh.get_group(probe_axis) if _axis_size(mesh, probe_axis) > 1 else None
		self._rpr, self._h = int(rows), int(h)
		self._spec = spec or CarrySpec(self._rpr + 2 * self._h, self._h, self._rpr)
		self._lo = _local_rank(mesh, op_axis) * self._rpr

	def float_tensors(self) -> tuple:
		return self.local.float_tensors()

	# -- the global face -------------------------------------------------------
	def _window(self, X: torch.Tensor, dim: int) -> torch.Tensor:
		"""The rows of a replicated block ``X`` (along ``dim``) that the rank's apply reads: the whole
		block (allgather), or the rank's carry window (halo: see :meth:`_own_rows`)."""
		return X if self.comm != "halo" else self._own_rows(X, dim)

	def _own_rows(self, X: torch.Tensor, dim: int) -> torch.Tensor:
		"""The rank's window of a replicated block, ``spec.ld`` rows with its own at ``spec.lo``
		(at least ``h`` on each side), zero past the ends."""
		n = X.shape[dim]
		a = self._lo - self._spec.lo
		b = a + self._spec.ld
		if a == 0 and b == n:
			return X
		lo, hi = min(max(a, 0), n), max(min(b, n), 0)
		if hi <= lo:
			shape = list(X.shape)
			shape[dim] = b - a
			return torch.zeros(shape, dtype=X.dtype, device=X.device)
		pad = (lo - a, b - hi)
		return F.pad(X.narrow(dim, lo, hi - lo), pad if dim == X.ndim - 1 else (0, 0) + pad)

	def _rows(self, X: torch.Tensor) -> torch.Tensor:
		"""The rank's own rows of a probe-major carry."""
		return self._spec.rows(X)

	def _probe_cols(self, k: int) -> Optional[slice]:
		"""The rank's columns of a ``k``-column block, or None where there is no probe axis or ``k``
		does not split evenly (those applies run replicated, as JAX's ``_probe_axis_or_none``)."""
		if self.probe_group is None:
			return None
		P = dist.get_world_size(self.probe_group)
		if k % P:
			return None
		w = k // P
		p = dist.get_rank(self.probe_group)
		return slice(p * w, (p + 1) * w)

	def _local_nm(self, W: torch.Tensor) -> torch.Tensor:
		return self.local.matmat(W)

	def _local_t(self, Wt: torch.Tensor) -> torch.Tensor:
		return self.local.matmat_t(Wt)

	def _matmat(self, V: torch.Tensor) -> torch.Tensor:
		V = torch.as_tensor(V, dtype=self.dtype, device=self.device)
		k = V.shape[1]
		cols = self._probe_cols(k)
		Y = self._local_nm(self._window(V if cols is None else V[:, cols], 0))
		Y = all_gather_rows(Y, self.shape[0], self.op_group, 0)
		return Y if cols is None else all_gather_rows(Y, k, self.probe_group, 1)

	def matmat_t(self, Vt: torch.Tensor) -> torch.Tensor:
		Vt = torch.as_tensor(Vt, dtype=self.dtype, device=self.device)
		k = Vt.shape[0]
		cols = self._probe_cols(k)
		Y = self._local_t(self._window(Vt if cols is None else Vt[cols], 1))
		Y = all_gather_rows(Y, self.shape[0], self.op_group, 1)
		return Y if cols is None else all_gather_rows(Y, k, self.probe_group, 0)

	# -- the local face ---------------------------------------------------------
	def sweep_rows(self, nv: int, split_probes: bool = True, phys: bool = False) -> _SweepRows:
		"""The rank's rows (and probe slice) of every carried block. ``phys=True`` asks for the padded
		carry, which only a real :class:`ShardedDIAOperator` carries: ``ValueError`` here."""
		if phys:
			raise ValueError(f"phys=True needs an operator with a padded carry (a real DIA operator); got {type(self).__name__}")
		return _SweepRows(self, self._probe_cols(nv) if split_probes else None)

	def _exchange(self, q: torch.Tensor) -> None:
		"""Fill the halo columns of a sweep carry from the ring neighbours, in place."""
		halo_exchange(q, self._h, self.op_group, 1, lo=self._spec.lo, n_rows=self._rpr)

	def _apply_carry(self, q: torch.Tensor) -> torch.Tensor:
		"""``A q`` on a sweep carry, carry-shaped (zero halo columns)."""
		if self.comm == "halo":
			self._exchange(q)
			w = self._local_t(q)
		else:
			w = self._local_t(all_gather_rows(q, self.shape[1], self.op_group, 1))
		spec = self._spec
		return F.pad(w, (spec.lo, spec.ld - spec.lo - spec.n)) if spec.ld != spec.n else w

	def _reduce(self, t: torch.Tensor) -> torch.Tensor:
		return all_reduce_rows(t, self.op_group)

	def lanczos_step(self, q_cur, q_prev, beta, layout=None):
		"""The step on sweep carries: ``v = A·q_cur − β·q_prev`` and ``α`` summed over the op group
		(``layout``, the sweep's :meth:`sweep_rows`, is the operator's own)."""
		acc = torch.promote_types(q_cur.dtype, torch.float32)
		v = self._apply_carry(q_cur).to(acc) - beta[:, None] * q_prev.to(acc)
		return v, self._reduce(row_dot(self._rows(q_cur.to(acc)), self._rows(v)))

	def lanczos_sweep_step(self, v_cur, v_prev, state, alpha_out, beta_out, residual_tol: float, layout=None):
		"""The whole step on sweep carries: the halo exchange and the rank's apply, then
		:func:`~primate_tpu_torch.ops.dia.lanczos_sweep_step_ref`'s arithmetic with its two sums
		(α and β) finished over the op group."""
		return lanczos_sweep_step_ref(
			self._apply_carry, v_cur, v_prev, state, alpha_out, beta_out, residual_tol, reduce=self._reduce, spec=self._spec
		)


class ShardedDenseOperator(_Sharded):
	"""A dense matrix row-partitioned across the ``op`` axis: each rank holds ``ceil(m / n_op)`` rows
	and multiplies them by the whole block (``torch.matmul``), then the output rows are gathered."""

	def __init__(self, A, mesh, op_axis: str = "op", dtype=None, device=None):
		A = A.A if isinstance(A, DenseOperator) else A
		if device is None:
			device = A.device if isinstance(A, torch.Tensor) else "cuda"
		A = torch.as_tensor(A, dtype=torch_dtype(dtype), device=device)
		if A.ndim != 2:
			raise ValueError("Operator must be two dimensional.")
		m = A.shape[0]
		ndev = _axis_size(mesh, op_axis)
		rpd = -(-m // ndev)
		lo = _local_rank(mesh, op_axis) * rpd
		block = A[min(lo, m) : min(lo + rpd, m)]
		if block.shape[0] < rpd:
			block = F.pad(block, (0, 0, 0, rpd - block.shape[0]))
		self._setup(DenseOperator(block.contiguous()), A.shape, mesh, op_axis, None, "allgather", rpd, 0)

	def rmatmat(self, V: torch.Tensor) -> torch.Tensor:
		"""``A† V``: each rank's rows against its rows of ``V``, summed over the op group."""
		V = torch.as_tensor(V, dtype=self.dtype, device=self.device)
		single = V.ndim == 1
		V = V[:, None] if single else V
		rows = V[min(self._lo, V.shape[0]) : self._lo + self._rpr]
		if rows.shape[0] < self._rpr:
			rows = F.pad(rows, (0, 0, 0, self._rpr - rows.shape[0]))
		parts = all_gather_rows(self.local.rmatmat(rows)[None], dist.get_world_size(self.op_group), self.op_group, 0)
		out = torch.sum(parts, dim=0)
		return out[:, 0] if single else out

	def rmatvec(self, v: torch.Tensor) -> torch.Tensor:
		return self.rmatmat(v)


def _partition_bsr_host(blocks: np.ndarray, indices: np.ndarray, indptr: np.ndarray, ndev: int, halo_col: bool):
	"""Split BSR block rows into ``ndev`` equal contiguous chunks of ``bpd = ceil(n_brow / ndev)``
	(host side, ``primate_tpu/parallel/sharded.py:103-180``). Returns each device's
	``(local block rows, block columns, tiles)``, ``bpd``, whether the pattern satisfies the ±1-neighbour
	halo condition, and the block bandwidth over structural (not all-zero) tiles."""
	n_brow = len(indptr) - 1
	rowids = np.repeat(np.arange(n_brow), np.diff(indptr))
	bpd = -(-n_brow // ndev)
	n_brow_pad = bpd * ndev
	halo_ok, bwb, parts = True, 0, []
	for d in range(ndev):
		lo, hi = d * bpd, (d + 1) * bpd
		sel = (rowids >= lo) & (rowids < hi)
		rb, cb, bl = rowids[sel] - lo, indices[sel], blocks[sel]
		if halo_col and cb.size:
			# Only structural tiles count: conversions store explicit zero tiles (empty block rows,
			# stored zeros far from the band), which must not disqualify a banded matrix.
			nz = np.abs(bl).reshape(bl.shape[0], -1).max(axis=1) > 0
			cnz = cb[nz]
			halo_ok &= bool(np.all((cnz >= (d - 1) * bpd) & (cnz < (d + 2) * bpd))) if cnz.size else True
			if cnz.size:
				bwb = max(bwb, int(np.abs(cnz - (rb[nz] + lo)).max()))
			# A zero tile may carry any block column: point it at one inside the halo window.
			cb = np.where(nz, cb, min(lo, n_brow_pad - 1)).astype(cb.dtype)
		parts.append((rb, cb, bl))
	return parts, bpd, halo_ok, bwb


class ShardedBSROperator(_Sharded):
	"""Block-sparse operator row-partitioned across the ``op`` axis: each rank holds ``bpd`` block
	rows as a :class:`~primate_tpu_torch.operators.sparse.BSROperator`, applied by ``bsr_spmm``
	(``primate_tpu/parallel/sharded.py:214-470``). With ``comm="halo"`` its block columns are
	remapped into the window ``[lo − halo, hi + halo)`` block rows; ``halo`` is the block bandwidth."""

	@classmethod
	def from_bsr(
		cls, A, mesh, op_axis: str = "op", probe_axis: Optional[str] = None, comm: str = "auto",
		blocksize: Optional[Tuple[int, int]] = None, dtype=None, use_pallas: Optional[bool] = None, device=None,
	) -> "ShardedBSROperator":
		"""Partition a BSR operator or a scipy sparse matrix across ``mesh[op_axis]``. ``use_pallas``
		(the TPU kernel's switch) is accepted and has no counterpart: the apply is ``bsr_spmm``."""
		del use_pallas
		device = _device_of(A, device)
		if not isinstance(A, BSROperator):
			A = BSROperator.from_scipy(A, blocksize=blocksize, dtype=torch_dtype(dtype), device="cpu")
		blocks = A.blocks.detach().cpu().numpy()
		indices = A.indices.cpu().numpy()
		indptr = A.indptr.cpu().numpy()
		bm, bn = blocks.shape[1:]
		ndev = _axis_size(mesh, op_axis)
		square = bm == bn and A.shape[0] == A.shape[1]
		if comm == "halo" and not square:
			raise ValueError("comm='halo' requires a square operator with square (bm == bn) blocks.")
		want_halo = comm in ("auto", "halo") and square
		parts, bpd, halo_ok, bwb = _partition_bsr_host(blocks, indices, indptr, ndev, halo_col=want_halo)
		if want_halo and halo_ok:
			mode, halo = "halo", int(min(max(bwb, 1), bpd))
		else:
			if comm == "halo":
				raise ValueError(
					"comm='halo' requires every stored block within ±1 neighbor's rows; "
					"reorder the matrix (e.g. RCM) or use comm='allgather'."
				)
			if want_halo:  # auto fell through: partition again with the global block columns
				parts, bpd, _, _ = _partition_bsr_host(blocks, indices, indptr, ndev, halo_col=False)
			mode, halo = "allgather", 0
		d = _local_rank(mesh, op_axis)
		rb, cb, bl = parts[d]
		if mode == "halo":
			cb = cb - (d * bpd - halo)
			if cb.size and (cb.min() < 0 or cb.max() >= bpd + 2 * halo):
				raise AssertionError(f"internal: halo colid outside window [0, {bpd + 2 * halo})")
			n_cols = (bpd + 2 * halo) * bn
		else:
			n_cols = A.shape[1]
		local_indptr = np.concatenate([[0], np.cumsum(np.bincount(rb, minlength=bpd))])
		tdtype = torch_dtype(dtype) or A.dtype
		local = BSROperator.from_numpy(bl, cb, local_indptr, (bpd * bm, n_cols), dtype=tdtype, device=device)
		op = cls.__new__(cls)
		op.bpd, op.halo = bpd, halo
		op._setup(local, A.shape, mesh, op_axis, probe_axis, mode, bpd * bm, halo * bm)
		return op

	@property
	def blocksize(self) -> Tuple[int, int]:
		return self.local.blocksize

	@property
	def colids(self) -> torch.Tensor:
		"""The rank's block-column ids (window-local under ``comm="halo"``)."""
		return self.local.indices


class ShardedDIAOperator(_Sharded):
	"""Banded (DIA) operator row-partitioned with a minimal halo (``primate_tpu/parallel/sharded.py:473-609``).

	Each rank holds ``n_loc = ceil(n / n_op)`` rows of every band in the columns of its padded carry
	(:func:`~primate_tpu_torch.ops.dia.carry_spec` of ``n_loc`` rows and ``moff = max|offset|``: ``ld``
	columns, the rows at ``[lo, lo + n_loc)``, ``lo ≥ moff`` and ``ld`` whole 128-byte lines), zero
	elsewhere, as a square :class:`~primate_tpu_torch.operators.sparse.DIAOperator` of side ``ld``:
	the global face's stencils run on the rank's ``ld``-row window and keep its rows, and the sweep's
	steps run the step kernels on the carry after a halo exchange of ``moff`` columns, α and β
	all-reduced between the passes. Requires ``moff ≤ n_loc`` (±1-neighbour halo)."""

	@classmethod
	def from_dia(cls, A, mesh, op_axis: str = "op", probe_axis: Optional[str] = None, dtype=None, device=None) -> "ShardedDIAOperator":
		device = _device_of(A, device)
		if not isinstance(A, DIAOperator):
			A = DIAOperator.from_scipy(A, dtype=torch_dtype(dtype), device="cpu")
		n = A.shape[0]
		if A.shape[1] != n:
			raise ValueError(f"a sharded DIA operator must be square; got {A.shape}")
		ndev = _axis_size(mesh, op_axis)
		n_loc = -(-n // ndev)
		moff = max((abs(o) for o in A.offsets), default=0)
		if moff > n_loc:
			raise ValueError(
				f"halo width {moff} exceeds rows-per-chip {n_loc}; use fewer chips or reorder (RCM) to shrink the band."
			)
		lo = _local_rank(mesh, op_axis) * n_loc
		bands = A.bands.detach().to(device=device, dtype=torch_dtype(dtype) or A.dtype)
		spec = carry_spec(n_loc, moff, bands.element_size())
		ext = torch.zeros((len(A.offsets), spec.ld), dtype=bands.dtype, device=device)
		width = max(0, min(n, lo + n_loc) - lo)
		ext[:, spec.lo : spec.lo + width] = bands[:, lo : lo + width]
		op = cls.__new__(cls)
		op.offsets = A.offsets
		op._setup(DIAOperator(ext, A.offsets, (spec.ld, spec.ld)), A.shape, mesh, op_axis, probe_axis, "halo", n_loc, moff, spec)
		return op

	def sweep_rows(self, nv: int, split_probes: bool = True, phys: bool = False) -> _SweepRows:
		"""The rank's rows of every carried block, in its padded carry (``phys=True`` changes nothing;
		``ValueError`` for a complex operator, whose steps do not take that carry's kernels)."""
		if phys and self.dtype.is_complex:
			raise ValueError(f"phys=True needs a real DIA operator; this one is {self.dtype}")
		return super().sweep_rows(nv, split_probes)

	def _local_nm(self, W: torch.Tensor) -> torch.Tensor:
		return self.local.matmat(W).narrow(0, self._spec.lo, self._rpr)

	def _local_t(self, Wt: torch.Tensor) -> torch.Tensor:
		return self.local.matmat_t(Wt).narrow(1, self._spec.lo, self._rpr)

	def _apply_carry(self, q: torch.Tensor) -> torch.Tensor:
		# The stencil on the whole carry: its columns outside the rows have zero bands, so no pad or slice.
		self._exchange(q)
		return self.local.matmat_t(q)

	def lanczos_step(self, q_cur, q_prev, beta, layout=None):
		"""Pass A on the carry after the halo exchange (``lanczos_dia_step``), α summed over the op
		group; a complex operator takes the plain step through the complex ``dia_stencil_t``."""
		if self.dtype.is_complex:
			return super().lanczos_step(q_cur, q_prev, beta)
		self._exchange(q_cur)
		return lanczos_dia_step(self.local.bands, self.local.offsets_t, q_cur, q_prev, beta, self._spec, self._reduce)

	def lanczos_sweep_step(self, v_cur, v_prev, state, alpha_out, beta_out, residual_tol: float, layout=None):
		"""The whole step on the carry after the halo exchange: ``lanczos_dia_sweep_step`` with its two
		sums all-reduced over the op group between the passes, and the state advanced from them by the
		next step's pass A or by :meth:`lanczos_sweep_flush`; a complex operator takes the plain step
		through the complex ``dia_stencil_t``."""
		if self.dtype.is_complex:
			return super().lanczos_sweep_step(v_cur, v_prev, state, alpha_out, beta_out, residual_tol)
		self._exchange(v_cur)
		return lanczos_dia_sweep_step(
			self.local.bands, self.local.offsets_t, v_cur, v_prev, state, alpha_out, beta_out, residual_tol, self._spec,
			self._reduce,
		)

	def lanczos_sweep_flush(self, state) -> None:
		"""Run the finish that the last real step left pending (``lanczos_dia_finish``: the advance kernel on
		the card), so that the state and the step's α and β can be read."""
		lanczos_dia_finish(state)

	def lanczos_round_step(self, q_cur, q_prev, state, alpha_out, beta_out, residual_tol: float, layout=None):
		"""The whole bfloat16 step on the carry after the halo exchange: pass A (the stencil rounded, as
		JAX's sharded apply rounds it) with its α all-reduced over the op group, then the round pair with
		its Σv² all-reduced before B2 (:func:`~primate_tpu_torch.ops.dia.lanczos_dia_round_step`)."""
		self._exchange(q_cur)
		return lanczos_dia_round_step(
			self.local.bands, self.local.offsets_t, q_cur, q_prev, state, alpha_out, beta_out, residual_tol, self._spec,
			self._reduce,
		)


def _partition_csr_host(data: np.ndarray, indices: np.ndarray, indptr: np.ndarray, n_cols: int, ndev: int, halo_col: bool):
	"""Split CSR rows into ``ndev`` equal contiguous chunks of ``rpd = ceil(n / ndev)`` (host side,
	``primate_tpu/parallel/sharded.py:612-673``). Returns each device's ``(local rows, columns,
	values)``, ``rpd``, whether every nonzero lies within the ±1-neighbour rows, and the bandwidth."""
	n = len(indptr) - 1
	counts = np.diff(indptr)
	rpd = -(-n // ndev)
	nnz = int(data.shape[0])
	if nnz and int(indices.max()) >= n_cols:
		raise ValueError(f"CSR column index {int(indices.max())} out of range for {n_cols} columns")
	halo_ok, bw, parts = True, 0, []
	for d in range(ndev):
		lo, hi = d * rpd, min((d + 1) * rpd, n)
		a, b = (int(indptr[lo]), int(indptr[hi])) if lo < n else (nnz, nnz)
		rb = np.repeat(np.arange(lo, hi) - lo, counts[lo:hi]) if lo < n else np.zeros(0, np.int64)
		cb, vb = indices[a:b], data[a:b]
		if halo_col and cb.size:
			halo_ok &= bool(np.all((cb >= (d - 1) * rpd) & (cb < (d + 2) * rpd)))
			bw = max(bw, int(np.abs(cb - (rb + lo)).max()))
		parts.append((rb, cb, vb))
	return parts, rpd, halo_ok, bw


class ShardedCSROperator(_Sharded):
	"""General-sparsity CSR operator row-partitioned across the ``op`` axis
	(``primate_tpu/parallel/sharded.py:695-952``): each rank holds its rows as a
	:class:`~primate_tpu_torch.operators.sparse.CSROperator` (one cuSPARSE SpMM an apply), so a
	scattered pattern keeps its nnz-proportional storage. Under ``comm="halo"`` its columns are
	remapped into the window ``[lo − halo, hi + halo)``; ``halo`` is the bandwidth."""

	@classmethod
	def from_csr(
		cls, A, mesh, op_axis: str = "op", probe_axis: Optional[str] = None, comm: str = "auto", dtype=None,
		use_pallas: Optional[bool] = None, device=None,
	) -> "ShardedCSROperator":
		"""Partition a CSR operator or a scipy sparse matrix across ``mesh[op_axis]``. ``use_pallas`` is
		accepted for signature compatibility with the BSR and DIA paths and ignored."""
		del use_pallas
		device = _device_of(A, device)
		if isinstance(A, CSROperator):
			data, indices, indptr, shape = (
				A.data.detach().cpu().numpy(), A.indices.cpu().numpy(), A.indptr.cpu().numpy(), A.shape
			)
		else:
			import scipy.sparse as sps

			A = sps.csr_matrix(A) if not (sps.issparse(A) and A.format == "csr") else A
			data, indices, indptr, shape = A.data, A.indices, A.indptr, A.shape
		ndev = _axis_size(mesh, op_axis)
		if comm == "halo" and shape[0] != shape[1]:
			raise ValueError("comm='halo' requires a square operator; use comm='allgather'.")
		want_halo = comm in ("auto", "halo") and shape[0] == shape[1]
		parts, rpd, halo_ok, bw = _partition_csr_host(data, indices, indptr, shape[1], ndev, halo_col=want_halo)
		if want_halo and halo_ok:
			mode, halo = "halo", int(min(max(bw, 1), rpd))
		else:
			if comm == "halo":
				raise ValueError(
					"comm='halo' requires every nonzero within ±1 neighbor's rows; "
					"reorder the matrix (e.g. RCM) or use comm='allgather'."
				)
			mode, halo = "allgather", 0
		d = _local_rank(mesh, op_axis)
		rb, cb, vb = parts[d]
		n_cols = shape[1]
		if mode == "halo":
			cb = cb - (d * rpd - halo)
			n_cols = rpd + 2 * halo
		local_indptr = np.concatenate([[0], np.cumsum(np.bincount(rb, minlength=rpd))])
		local = CSROperator.from_numpy(vb, cb, local_indptr, (rpd, n_cols), dtype=torch_dtype(dtype), device=device)
		op = cls.__new__(cls)
		op.rpd, op.halo, op._nnz = rpd, halo, int(len(data))
		op._setup(local, shape, mesh, op_axis, probe_axis, mode, rpd, halo)
		return op

	@property
	def nnz(self) -> int:
		"""The stored entries of the whole matrix (the JAX package's count adds its per-device
		ELL padding, a layout the port does not build)."""
		return self._nnz


def shard_operator(A, mesh, op_axis: str = "op", probe_axis: Optional[str] = None, comm: str = "auto", **kwargs) -> LinearOperator:
	"""Partition any supported operator across a mesh axis (``primate_tpu/parallel/sharded.py:955-992``).

	Dense tensors and arrays → :class:`ShardedDenseOperator`; DIA → :class:`ShardedDIAOperator`;
	BSR (or an explicit ``blocksize=``) → :class:`ShardedBSROperator`; CSR and general scipy sparse →
	:class:`ShardedCSROperator`, which keeps a scattered pattern's nnz-proportional storage (pass
	``blocksize=`` to opt into BSR; its fill-in warning then applies). ``device`` (a keyword) is where
	the rank's block goes: the operator's own device, or the card for host matrices."""
	import scipy.sparse as sps

	if isinstance(A, (torch.Tensor, np.ndarray)) and getattr(A, "ndim", 0) == 2:
		return ShardedDenseOperator(A, mesh, op_axis, dtype=kwargs.pop("dtype", None), device=kwargs.pop("device", None))
	if isinstance(A, DIAOperator):
		return ShardedDIAOperator.from_dia(A, mesh, op_axis, probe_axis, **kwargs)
	if isinstance(A, BSROperator):
		return ShardedBSROperator.from_bsr(A, mesh, op_axis, probe_axis, comm, **kwargs)
	if isinstance(A, CSROperator):
		if "blocksize" in kwargs:
			bsr = A.tobsr(kwargs.pop("blocksize"))
			return ShardedBSROperator.from_bsr(bsr, mesh, op_axis, probe_axis, comm, **kwargs)
		return ShardedCSROperator.from_csr(A, mesh, op_axis, probe_axis, comm, **kwargs)
	if sps.issparse(A):
		if getattr(A, "format", None) == "dia":
			return ShardedDIAOperator.from_dia(A, mesh, op_axis, probe_axis, **kwargs)
		if getattr(A, "format", None) == "bsr" or "blocksize" in kwargs:
			return ShardedBSROperator.from_bsr(A, mesh, op_axis, probe_axis, comm, **kwargs)
		return ShardedCSROperator.from_csr(A, mesh, op_axis, probe_axis, comm, **kwargs)
	if isinstance(A, DenseOperator):
		return ShardedDenseOperator(A, mesh, op_axis, dtype=kwargs.pop("dtype", None), device=kwargs.pop("device", None))
	raise TypeError(f"Cannot shard operator of type {type(A)}")


def auto_shard_operator(
	A, mesh, op_axis: str = "op", probe_axis: Optional[str] = None, comm: str = "auto", reorder: str = "auto", dtype=None,
	**kwargs,
):
	"""Prepare (format and ordering) and partition a matrix in one step
	(``primate_tpu/parallel/sharded.py:995-1027``): :func:`~primate_tpu_torch.operators.prepare.auto_operator`
	on the host, then :func:`shard_operator`. A bandwidth-reducing order is doubly useful sharded: the
	halo width is the bandwidth, so RCM turns a partition whose halo would pass a rank's rows (an
	error) into a minimal-halo stencil. Returns ``(sharded_op, PrepInfo)``; keywords go by signature
	to the preparation (``dia_fill_limit``, ``blocksize``, …) and to the sharding (``device``, …)."""
	from ..operators.prepare import auto_operator
	from ..utils.kwargs import restrict_kwargs, setdiff_kwargs

	device = kwargs.pop("device", None)
	prep_kwargs = restrict_kwargs(auto_operator, kwargs)
	shard_kwargs = setdiff_kwargs(auto_operator, kwargs)
	op, info = auto_operator(A, dtype=dtype, reorder=reorder, device="cpu", **prep_kwargs)
	sharded = shard_operator(op, mesh, op_axis=op_axis, probe_axis=probe_axis, comm=comm, device=device or "cuda", **shard_kwargs)
	return sharded, info
