"""Checkpoint and resume of long estimations (counterpart of ``primate_tpu/utils/checkpoint.py``).

An estimator's state is a small nested structure of tensors (sample count, Welford
moments), so a checkpoint is one ``.npz`` archive: the leaves as arrays and the nesting
as a JSON document beside them. Nothing in the archive is pickled, and loading one
imports no module but the port's own (a NamedTuple of another module comes back as a
``collections.namedtuple`` of the same name and fields).

``save_pytree``/``load_pytree`` round-trip a nested dict, list, tuple or NamedTuple of
tensors, numpy arrays and Python scalars; array leaves come back as tensors on
``device``, scalars as they were. ``EstimatorCheckpoint`` is the per-batch callback of
:func:`~primate_tpu_torch.hutch`: it snapshots the iteration count, the estimate and the
estimator's moments every ``every`` calls.
"""

import collections
import importlib
import json
from pathlib import Path
from typing import Any, Optional, Union

import numpy as np
import torch

__all__ = ["save_pytree", "load_pytree", "EstimatorCheckpoint"]

_STRUCTURE = "__structure__"


def _norm_path(path: Union[str, Path]) -> Path:
	"""``np.savez`` appends ``.npz``: normalise so that save and load agree."""
	path = Path(path)
	return path if path.suffix == ".npz" else path.with_suffix(path.suffix + ".npz")


def _is_namedtuple(x) -> bool:
	return isinstance(x, tuple) and hasattr(type(x), "_fields")


def _flatten(node, leaves: list) -> dict:
	"""The JSON description of ``node``; its array leaves are appended to ``leaves``."""
	if isinstance(node, torch.Tensor):
		leaves.append(node.detach().cpu().numpy())
		return {"leaf": len(leaves) - 1}
	if isinstance(node, (np.ndarray, np.generic)):
		leaves.append(np.asarray(node))
		return {"leaf": len(leaves) - 1}
	if node is None or isinstance(node, (bool, int, float, str)):
		return {"value": node}
	if isinstance(node, dict):
		if not all(isinstance(k, str) for k in node):
			raise TypeError("checkpoint dicts need string keys")
		return {"dict": {k: _flatten(v, leaves) for k, v in node.items()}}
	if _is_namedtuple(node):
		cls = type(node)
		return {
			"namedtuple": {"module": cls.__module__, "name": cls.__qualname__, "fields": list(cls._fields)},
			"items": [_flatten(v, leaves) for v in node],
		}
	if isinstance(node, (list, tuple)):
		return {"list" if isinstance(node, list) else "tuple": [_flatten(v, leaves) for v in node]}
	raise TypeError(f"cannot checkpoint a {type(node).__name__}")


def _namedtuple_class(spec: dict):
	"""The port's own NamedTuple class named by ``spec``, else a plain namedtuple with its fields."""
	module, name, fields = spec["module"], spec["name"], spec["fields"]
	if module.split(".")[0] == "primate_tpu_torch":
		cls = importlib.import_module(module)
		for part in name.split("."):
			cls = getattr(cls, part, None)
		if cls is not None and tuple(getattr(cls, "_fields", ())) == tuple(fields):
			return cls
	return collections.namedtuple(name.split(".")[-1], fields)


def _unflatten(spec: dict, leaves, device):
	if "leaf" in spec:
		return torch.as_tensor(leaves[spec["leaf"]], device=device)
	if "value" in spec:
		return spec["value"]
	if "dict" in spec:
		return {k: _unflatten(v, leaves, device) for k, v in spec["dict"].items()}
	if "namedtuple" in spec:
		return _namedtuple_class(spec["namedtuple"])(*(_unflatten(v, leaves, device) for v in spec["items"]))
	if "list" in spec:
		return [_unflatten(v, leaves, device) for v in spec["list"]]
	return tuple(_unflatten(v, leaves, device) for v in spec["tuple"])


def save_pytree(path: Union[str, Path], tree: Any) -> None:
	"""Write a nested structure of tensors, arrays and scalars to ``path`` (one ``.npz``)."""
	leaves: list = []
	structure = json.dumps(_flatten(tree, leaves))
	arrays = {f"leaf_{i}": x for i, x in enumerate(leaves)}
	np.savez(_norm_path(path), **{_STRUCTURE: np.frombuffer(structure.encode(), dtype=np.uint8)}, **arrays)


def load_pytree(path: Union[str, Path], device="cuda") -> Any:
	"""Read a structure written by :func:`save_pytree`: its array leaves as tensors on ``device``."""
	with np.load(_norm_path(path), allow_pickle=False) as data:
		spec = json.loads(data[_STRUCTURE].tobytes().decode())
		leaves = {int(k[len("leaf_"):]): data[k] for k in data.files if k.startswith("leaf_")}
	return _unflatten(spec, leaves, device)


class EstimatorCheckpoint:
	"""Periodic snapshots of an adaptive estimation, as a ``callback``::

	    ckpt = EstimatorCheckpoint("run.npz", every=10)
	    hutch(A, callback=ckpt, ...)
	    state = ckpt.load()          # {'nit': ..., 'estimate': ..., 'state': {'n', 'mean', 'var'}}

	The ``state`` entry comes from the estimator's ``snapshot()``: the sample count, the
	running mean and the mean per-output sample variance (NaN until there are two samples).
	"""

	def __init__(self, path: Union[str, Path], every: int = 1, device="cuda"):
		self.path = Path(path)
		self.every = int(every)
		self.device = device
		self._calls = 0

	def __call__(self, result) -> None:
		self._calls += 1
		if self._calls % self.every:
			return
		payload = {
			"nit": np.asarray(getattr(result, "nit", self._calls)),
			"estimate": np.asarray(getattr(result, "estimate", np.nan)),
		}
		est = getattr(result, "estimator", None)
		if est is not None and hasattr(est, "snapshot"):
			snap = est.snapshot()
			payload["state"] = {
				"n": np.asarray(snap.n),
				"mean": snap.estimate,
				"var": snap.var if snap.var is not None else np.asarray(np.nan),
			}
		save_pytree(self.path, payload)

	def load(self) -> Optional[dict]:
		"""The last snapshot, its arrays as tensors on ``device``; None before the first."""
		return load_pytree(self.path, device=self.device) if _norm_path(self.path).exists() else None
