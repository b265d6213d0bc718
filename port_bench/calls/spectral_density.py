"""The SLQ density of states: ``spectral_density(A, grid, deg, nv, pdf, orth)``, one Lanczos sweep of
``nv`` probes, each probe's Gauss rule broadened by a Gaussian on ``grid`` points."""

import numpy as np

from .. import faults as _faults
from ..reference import lanczos, probes


def program(ptt, op, traffic: dict):
	kw = {k: traffic[k] for k in ("grid", "deg", "nv", "pdf", "orth")}

	def call(seed):
		ts, phi = ptt.spectral_density(op, seed=seed, **kw)
		return np.asarray(ts, np.float64), np.asarray(phi, np.float64)

	return call


def reference(ref, traffic: dict, seed: int) -> tuple:
	V = probes.draw(seed, 0, ref.n, traffic["nv"], traffic["pdf"], ref.probe_dtype(traffic["pdf"]), ref.device)
	rules = [lanczos.gauss_rule(*lanczos.lanczos(ref.apply, blk.to(ref.work), traffic["deg"], traffic["orth"], 1, ref.rnd)[:2])
		for blk in V.split(ref.block)]
	nodes, weights = (np.concatenate(x) for x in zip(*rules))
	return lanczos.smoothed_density(nodes, weights, traffic["grid"], traffic["deg"])


def compare(got: tuple, want: tuple) -> dict:
	return {"dos_gap": float(np.max(np.abs(got[1] - want[1])) / np.max(np.abs(want[1])))}


def sweep(traffic: dict) -> dict:
	return {"kind": "lanczos", "steps": int(traffic["deg"]), "nv": int(traffic["nv"])}


def faults(traffic: dict, limit: float) -> dict:
	step = _faults.unchanged_window_step if traffic["orth"] > 0 else _faults.unchanged_sweep_step
	return {"unchanged_step": step, "half_batch": _faults.half_density_batch,
		"altered_answer": _faults.altered_answer("spectral_density", 2.0 * limit)}
