"""Stochastic Lanczos quadrature of ``tr f(A)``: ``hutch(MatrixFunction(A, fun, deg, orth), ...)``
with a count criterion, so every call runs ``count // batch`` sweeps of ``batch`` probes."""

import numpy as np

from .. import faults as _faults
from ..reference import lanczos, probes


def _batches(traffic: dict) -> int:
	return int(traffic["count"]) // int(traffic["batch"])


def program(ptt, op, traffic: dict):
	M = ptt.MatrixFunction(op, traffic["fun"], deg=traffic["deg"], orth=traffic["orth"],
		reorth_passes=traffic["reorth_passes"], dtype=op.dtype)
	kw = dict(batch=traffic["batch"], pdf=traffic["pdf"], converge="count", count=traffic["count"])
	return lambda seed: float(ptt.hutch(M, seed=seed, **kw))


def reference(ref, traffic: dict, seed: int) -> float:
	f = getattr(np, traffic["fun"])
	vals = []
	for it in range(_batches(traffic)):
		V = probes.draw(seed, it, ref.n, traffic["batch"], traffic["pdf"], ref.probe_dtype(traffic["pdf"]), ref.device)
		for blk in V.split(ref.block):
			a, b, norm_sq = lanczos.lanczos(ref.apply, blk.to(ref.work), traffic["deg"], traffic["orth"],
				traffic["reorth_passes"], ref.rnd)
			nodes, weights = lanczos.gauss_rule(a, b)
			vals.append(np.sum(weights * f(nodes), axis=1) * norm_sq)
	return float(np.mean(np.concatenate(vals)))


def compare(got: float, want: float) -> dict:
	return {"rel_gap": abs(got - want) / abs(want)}


def sweep(traffic: dict) -> dict:
	return {"kind": "lanczos", "steps": int(traffic["deg"]) * _batches(traffic), "nv": int(traffic["batch"])}


def faults(traffic: dict, limit: float) -> dict:
	step = _faults.unchanged_window_step if traffic["orth"] > 0 else _faults.unchanged_sweep_step
	return {"unchanged_step": step, "half_batch": _faults.half_hutch_batch, "altered_answer": _faults.altered_answer("hutch", 2.0 * limit)}
