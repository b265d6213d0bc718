"""Distributed execution over ``torch.distributed``: device meshes and sharded operators
(``primate_tpu/parallel``).

* **operator sharding**: the operator's rows are block-partitioned along the mesh's ``"op"`` axis;
  each apply is the rank's kernel on its rows plus a collective (an all-gather of the output rows,
  a ring halo exchange of the Lanczos carry, an all-reduce of each sum over n);
* **probe sharding**: probe columns are split along the ``"probe"`` axis;
* **entry**: :func:`initialize_distributed` joins the process group (NCCL on the cards, gloo on the
  host), given its address, world size and rank.

The collectives are in :mod:`~primate_tpu_torch.parallel._comm`; the two faces of a sharded
operator (replicated in and out for the estimators, row-sharded for the sweep) in
:mod:`~primate_tpu_torch.parallel.sharded`.
"""

from .mesh import initialize_distributed, make_mesh, mesh_devices
from .sharded import (
	ShardedBSROperator,
	ShardedCSROperator,
	ShardedDenseOperator,
	ShardedDIAOperator,
	auto_shard_operator,
	shard_operator,
)

__all__ = [
	"make_mesh",
	"mesh_devices",
	"initialize_distributed",
	"ShardedCSROperator",
	"ShardedDenseOperator",
	"ShardedBSROperator",
	"ShardedDIAOperator",
	"auto_shard_operator",
	"shard_operator",
]
