"""The kernel polynomial density of states: ``kpm_density(A, grid, m, nv, pdf, interval)``, one
block of ``nv`` probes through ``m − 1`` Chebyshev steps, Jackson-damped, on ``grid`` points."""

import numpy as np

from .. import faults as _faults
from ..reference import chebyshev, probes


def program(ptt, op, traffic: dict):
	kw = {k: traffic[k] for k in ("grid", "m", "nv", "pdf", "interval")}

	def call(seed):
		ts, phi = ptt.kpm_density(op, seed=seed, **kw)
		return np.asarray(ts, np.float64), np.asarray(phi, np.float64)

	return call


def reference(ref, traffic: dict, seed: int) -> tuple:
	if traffic["interval"] != "gershgorin":
		raise ValueError("the reference takes the Gershgorin interval only")
	lo, hi = ref.interval()
	c, r = (hi + lo) / 2.0, (hi - lo) / 2.0
	V = probes.draw(seed, 0, ref.n, traffic["nv"], traffic["pdf"], ref.probe_dtype(traffic["pdf"]), ref.device)
	mus = sum(chebyshev.moments(ref.apply, blk.to(ref.work), traffic["m"], c, r, ref.rnd) for blk in V.split(ref.block))
	return chebyshev.density(mus / traffic["nv"], (lo, hi), traffic["grid"], ref.n)


def compare(got: tuple, want: tuple) -> dict:
	return {"dos_gap": float(np.max(np.abs(got[1] - want[1])) / np.max(np.abs(want[1])))}


def sweep(traffic: dict) -> dict:
	return {"kind": "chebyshev", "steps": int(traffic["m"]) - 1, "nv": int(traffic["nv"])}


def faults(traffic: dict, limit: float) -> dict:
	return {"unchanged_step": _faults.unchanged_chebyshev_step, "half_batch": _faults.half_kpm_batch,
		"altered_answer": _faults.altered_answer("kpm_density", 2.0 * limit)}
