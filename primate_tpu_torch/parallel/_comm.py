"""The collectives the sharded operators need, over a ``torch.distributed`` process group.

The JAX package leaves these to GSPMD and ``shard_map`` (``psum``, ``all_gather`` by an out-spec,
``ppermute`` on a ring); here they are three explicit calls:

* :func:`all_reduce_rows`: the sum over the ``op`` group of a partial row reduction (a sum over
  the rank's rows of the Lanczos carry);
* :func:`halo_exchange`: the boundary rows of a row-sharded block with the ring neighbours, by
  ``batch_isend_irecv``. The first and the last rank exchange nothing across the ends of the ring:
  their outer halo stays zero (JAX's ``ppermute`` wraps round and relies on zero band entries
  there, and 0·inf is NaN);
* :func:`all_gather_rows`: the output rows of every rank, by one all-gather of equal (padded)
  blocks, differentiable: its backward sums the cotangents of the group and keeps the rank's own
  piece, as ``torch.distributed.nn.functional.all_gather`` does.

Transport: NCCL takes CUDA tensors. gloo takes host tensors only for send and receive, so under a
gloo group a CUDA tensor is staged through host memory here and nowhere else (two ranks on one
card, where NCCL refuses the second rank); the kernels still run on the card. Any other
combination raises.
"""

from typing import Optional

import torch
import torch.distributed as dist

__all__ = ["all_reduce_rows", "halo_exchange", "all_gather_rows"]

# The newer name of the same collective where the installed torch has it.
_all_gather_single = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def _staged(t: torch.Tensor, group) -> bool:
	"""Whether ``t`` must go through host memory for ``group``'s backend (raises where it cannot go)."""
	backend = dist.get_backend(group)
	if backend == "gloo":
		return t.device.type != "cpu"
	if backend == "nccl":
		if t.device.type != "cuda":
			raise ValueError(f"an NCCL group takes CUDA tensors; got one on {t.device}")
		return False
	raise NotImplementedError(f"the sharded operators' collectives run over nccl or gloo, not {backend}")


def all_reduce_rows(t: torch.Tensor, group) -> torch.Tensor:
	"""Sum ``t`` over ``group`` in place and return it."""
	if _staged(t, group):
		host = t.cpu()
		dist.all_reduce(host, group=group)
		t.copy_(host)
	else:
		dist.all_reduce(t, group=group)
	return t


def halo_exchange(X: torch.Tensor, h: int, group, dim: int = 1, lo: Optional[int] = None, n_rows: Optional[int] = None) -> None:
	"""Fill the halo of a row-sharded block in place from the ring neighbours.

	``X`` holds the rank's ``n_rows`` rows at ``[lo, lo + n_rows)`` along ``dim`` (1 for a
	probe-major carry, 0 for a node-major block) with at least ``h`` rows on each side (default:
	exactly ``h``, ``lo = h``). The rank sends its first ``h`` rows to the rank before it and its last
	``h`` to the rank after it, and receives theirs into ``[lo − h, lo)`` and
	``[lo + n_rows, lo + n_rows + h)``; the ends of the ring exchange nothing, and the rows outside
	those two ranges are left as they are."""
	size, rank = dist.get_world_size(group), dist.get_rank(group)
	if h == 0 or size == 1:
		return
	lo = h if lo is None else int(lo)
	n_loc = X.shape[dim] - 2 * h if n_rows is None else int(n_rows)
	if n_loc < h:
		raise ValueError(f"halo width {h} exceeds the {n_loc} rows a rank holds")
	if lo < h or lo + n_loc + h > X.shape[dim]:
		raise ValueError(f"rows [{lo}, {lo + n_loc}) leave no room for a halo of {h} in {X.shape[dim]}")
	staged = _staged(X, group)

	def wire(t: torch.Tensor) -> torch.Tensor:
		return t.to("cpu") if staged else t.contiguous()

	shape = list(X.shape)
	shape[dim] = h
	ops, recv = [], []
	for peer, send_at, recv_at in ((rank - 1, lo, lo - h), (rank + 1, lo + n_loc - h, lo + n_loc)):
		if not 0 <= peer < size:
			continue
		g = dist.get_global_rank(group, peer)
		buf = torch.empty(shape, dtype=X.dtype, device="cpu" if staged else X.device)
		ops.append(dist.P2POp(dist.isend, wire(X.narrow(dim, send_at, h)), g, group))
		ops.append(dist.P2POp(dist.irecv, buf, g, group))
		recv.append((recv_at, buf))
	for req in dist.batch_isend_irecv(ops):
		req.wait()
	for at, buf in recv:
		X.narrow(dim, at, h).copy_(buf)


def _gather(X: torch.Tensor, group, dim: int) -> torch.Tensor:
	"""The blocks of every rank of ``group``, equal in shape, concatenated along ``dim``: one
	all-gather of the blocks as they lie (``(size, *X.shape)``), then one copy that interleaves them
	along ``dim`` (none for ``dim = 0``), so a probe-major block is never transposed."""
	size = dist.get_world_size(group)
	src = X.contiguous()
	staged = _staged(src, group)
	wire = src.cpu() if staged else src
	out = torch.empty((size * wire.shape[0],) + tuple(wire.shape[1:]), dtype=wire.dtype, device=wire.device)
	_all_gather_single(out, wire, group=group)
	shape = X.shape[:dim] + (size * X.shape[dim],) + X.shape[dim + 1 :]
	return out.to(X.device).view((size,) + tuple(wire.shape)).movedim(0, dim).reshape(shape)


class _GatherRows(torch.autograd.Function):
	@staticmethod
	def forward(ctx, X, group, dim, n):
		ctx.group, ctx.dim, ctx.width = group, dim, X.shape[dim]
		return _gather(X, group, dim).narrow(dim, 0, n)

	@staticmethod
	def backward(ctx, G):
		group, dim, width = ctx.group, ctx.dim, ctx.width
		full = torch.zeros(
			G.shape[:dim] + (width * dist.get_world_size(group),) + G.shape[dim + 1 :], dtype=G.dtype, device=G.device
		)
		full.narrow(dim, 0, G.shape[dim]).copy_(G)
		all_reduce_rows(full, group)
		return full.narrow(dim, dist.get_rank(group) * width, width), None, None, None


def all_gather_rows(X: torch.Tensor, n: int, group, dim: int = 0) -> torch.Tensor:
	"""The blocks of every rank of ``group``, each ``X.shape[dim]`` long (the last padded), in rank
	order along ``dim`` and cut to ``n``: the whole product on every rank. Differentiable."""
	dim = dim % X.ndim
	return _GatherRows.apply(X, group, dim, int(n))
