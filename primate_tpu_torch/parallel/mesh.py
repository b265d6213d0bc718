"""Device meshes and process-group initialisation (``primate_tpu/parallel/mesh.py``).

Conventions, as in the JAX package:

* axis ``"op"``: the operator's rows are block-partitioned along it (one row block per rank);
* axis ``"probe"``: independent probe columns are split along it.

A mesh is a :class:`torch.distributed.device_mesh.DeviceMesh` over global ranks, rank
``o·n_probe + p`` at coordinate ``(o, p)``. Nothing here knows of a cluster: the caller hands
:func:`initialize_distributed` the address, world size and rank (``init_method="tcp://host:port"``).
"""

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

__all__ = ["make_mesh", "mesh_devices", "initialize_distributed"]


def _world() -> Tuple[int, int]:
	return (dist.get_world_size(), dist.get_rank()) if dist.is_initialized() else (1, 0)


def mesh_devices(n: Optional[int] = None, device_type: str = "cuda") -> list:
	"""The device of each global rank, in rank order (the first ``n``; all by default).

	Rank ``r`` drives ``cuda:(r mod cards per host)``, the rule ``DeviceMesh`` applies when a rank
	has chosen no card; ``device_type="cpu"`` gives the host for every rank."""
	world, _ = _world()
	if n is not None:
		if n > world:
			raise ValueError(f"Requested {n} devices but only {world} ranks are available.")
		world = n
	if device_type == "cpu":
		return [torch.device("cpu")] * world
	count = torch.cuda.device_count()
	if count == 0:
		raise RuntimeError("no CUDA device is visible: pass device_type='cpu' to run on the host")
	return [torch.device(device_type, r % count) for r in range(world)]


def make_mesh(
	shape: Optional[Tuple[int, ...]] = None,
	axis_names: Sequence[str] = ("op", "probe"),
	devices: Optional[Sequence[int]] = None,
	device_type: str = "cuda",
) -> DeviceMesh:
	"""A named mesh over global ranks for sharded estimation.

	``shape`` defaults to ``(world size, 1)``: every rank shards the operator's rows. Pass e.g.
	``shape=(2, 2)`` to split probes 2 ways as well; the product must equal the number of ranks
	used. ``devices`` are the global ranks to use (all by default, in order); every rank of the
	world calls this, and a rank outside ``devices`` gets a mesh it is not part of. The CPU is used
	only when asked for (``device_type="cpu"``, over gloo)."""
	world, _ = _world()
	ranks = list(range(world)) if devices is None else [int(r) for r in devices]
	if shape is None:
		shape = (len(ranks),) + (1,) * (len(axis_names) - 1)
	if int(np.prod(shape)) != len(ranks):
		raise ValueError(f"Mesh shape {tuple(shape)} needs {int(np.prod(shape))} ranks, have {len(ranks)}.")
	names = tuple(axis_names)[: len(shape)]
	return DeviceMesh(device_type, torch.tensor(ranks, dtype=torch.int64).reshape(tuple(shape)), mesh_dim_names=names)


def initialize_distributed(backend: Optional[str] = None, **kwargs) -> None:
	"""Join the process group: ``torch.distributed.init_process_group`` with backend ``nccl`` (the
	card) unless the caller names another (``"gloo"`` for ranks on the host). The other keywords
	(``init_method``, ``world_size``, ``rank``, ``timeout``, …) go to it unchanged."""
	dist.init_process_group(backend=backend or "nccl", **kwargs)
