"""The port's examples (``primate_tpu_torch.examples``) run end to end on the CPU at small sizes,
each with the checks its ``main`` makes against closed forms or a dense reference, and return
their numbers. On the card they run at their own sizes (``chip_smoke.py`` phase 22)."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from primate_tpu_torch.examples import gp_log_likelihood, graph_analysis, rectangular_spectra, spectrum_slicing, tight_binding

REPO = str(Path(__file__).resolve().parent.parent)

torch.set_num_threads(2)


def test_gp_log_likelihood_fits_and_matches_the_dense_loss():
	out = gp_log_likelihood.main("cpu", n=128, iters=12)
	assert out["exact"] < out["exact_at_start"] and out["rel_err_logdet"] <= 0.05 and out["rel_err_quad"] <= 1e-3
	assert len(out["history"]) == 12 and np.all(np.isfinite(out["history"]))


def test_graph_analysis_matches_the_dense_spectrum():
	out = graph_analysis.main("cpu", n=600)
	assert out["rel_err"]["comm"] <= 1e-4 and out["eigencount"] > 0


def test_rectangular_spectra_match_the_dense_svd():
	out = rectangular_spectra.main("cpu", m=600, n=160, r=8)
	assert out["rel_err"]["svds"] <= 1e-3 and len(out["singular_values"]) == 4


def test_spectrum_slicing_finds_the_window():
	out = spectrum_slicing.main("cpu", nx=24, ny=20)
	assert out["found"] == out["closed_form_count"] > 0 and out["max_err"] < 1e-3


def test_tight_binding_matches_the_dense_spectrum():
	out = tight_binding.main("cpu", nx=20, ny=20)
	assert abs(out["kpm_mass"] - 1.0) <= 1e-2 and out["rel_err"]["Z"] <= 0.05


def test_distributed_gp_fits_on_four_gloo_ranks():
	"""Four ranks on the host (a (2, 2) mesh: rows over 2, probes over 2), started by the example's
	own ``launch`` in a fresh interpreter: every rank fits the same s, within 20% of s* = 3."""
	code = (
		"import json; from primate_tpu_torch.examples import distributed_gp as d; "
		"r = d.launch(world=4, device='cpu', backend='gloo'); "
		"print('RESULT', json.dumps([[x['s_fit'], list(x['mesh']), x['n'], x['history'][-1]] for x in r]))"
	)
	env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
	r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=600, env=env)
	assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
	ranks = json.loads(next(line for line in r.stdout.splitlines() if line.startswith("RESULT"))[len("RESULT "):])
	assert len(ranks) == 4 and all(x == ranks[0] for x in ranks)
	s_fit, mesh, n, (nll, grad, exact) = ranks[0]
	assert mesh == [2, 2] and n == 256 and abs(s_fit - 3.0) / 3.0 < 0.2 and np.isfinite(nll)


@pytest.mark.parametrize(
	"name", ["gp_log_likelihood", "graph_analysis", "rectangular_spectra", "spectrum_slicing", "tight_binding", "distributed_gp"]
)
def test_each_example_defaults_to_the_card(name):
	"""``main()`` with no device runs on the card, which this machine lacks: it raises before any
	result (the port's entry points run on the card unless the caller asks for the CPU)."""
	import importlib
	import inspect

	mod = importlib.import_module(f"primate_tpu_torch.examples.{name}")
	assert inspect.signature(mod.main).parameters["device"].default is None
	if not torch.cuda.is_available():
		with pytest.raises((RuntimeError, AssertionError)):
			mod.main()
