"""The plain reference against closed forms, against the bands the program is handed, and its probes
against the program's own draw."""

import numpy as np
import pytest
import torch

from port_bench import harness, reference
from port_bench.reference import chebyshev, hofstadter, lanczos, path_laplacian, probes

from .conftest import BENCH

PATH = {"n": 64, "diagonal": 3.0, "off_diagonal": -1.0}
LATTICE = {"nx": 10, "ny": 12, "alpha": 0.2, "hopping": 1.0}


def dense(apply, n, dtype):
	return apply(torch.eye(n, dtype=dtype)).T.numpy()


def test_path_logdet_closed_form():
	A = dense(lambda X: path_laplacian.apply(PATH, X), 64, torch.float64)
	assert np.allclose(A, A.T)
	assert path_laplacian.logdet(PATH) == pytest.approx(np.linalg.slogdet(A)[1], rel=1e-13)


def test_full_lanczos_quadrature_is_exact():
	# deg = n with full re-orthogonalisation: the Gauss rule integrates v^T log(A) v exactly
	n = 64
	A = dense(lambda X: path_laplacian.apply(PATH, X), n, torch.float64)
	w, U = np.linalg.eigh(A)
	logA = (U * np.log(w)) @ U.T
	V = probes.draw(5, 0, n, 8, "rademacher", torch.float64, "cpu")
	a, b, norm_sq = lanczos.lanczos(lambda X: path_laplacian.apply(PATH, X), V, n, orth=n, passes=2)
	nodes, weights = lanczos.gauss_rule(a, b)
	want = np.einsum("pi,ij,pj->p", V.numpy(), logA, V.numpy())
	assert np.allclose(np.sum(weights * np.log(nodes), axis=1) * norm_sq, want, rtol=1e-10)


def test_hofstadter_traces_closed_form():
	# the n basis vectors as probes make the Chebyshev moments exact traces: T2 = 2x^2 - 1, T4 = 8x^4 - 8x^2 + 1
	n = hofstadter.size(LATTICE)
	lo, hi = hofstadter.interval(LATTICE)
	mus = chebyshev.moments(lambda X: hofstadter.apply(LATTICE, X), torch.eye(n, dtype=torch.complex128), 5, 0.0, hi)
	tr2 = 8.0 * (mus[2] + n)
	tr4 = 32.0 * (mus[4] - n) + 16.0 * tr2
	want2, want4 = hofstadter.traces(LATTICE)
	assert tr2 == pytest.approx(want2, rel=1e-12) and want2 == 4 * n
	assert tr4 == pytest.approx(want4, rel=1e-12)
	H = dense(lambda X: hofstadter.apply(LATTICE, X), n, torch.complex128)
	assert np.allclose(H, H.conj().T)
	assert lo <= np.linalg.eigvalsh(H).min() and np.linalg.eigvalsh(H).max() <= hi


def test_kpm_density_has_unit_mass():
	n = hofstadter.size(LATTICE)
	mus = chebyshev.moments(lambda X: hofstadter.apply(LATTICE, X), torch.eye(n, dtype=torch.complex128), 64, 0.0, 4.0)
	ts, phi = chebyshev.density(mus, (-4.0, 4.0), 2048, n)
	assert np.trapezoid(phi, ts) == pytest.approx(1.0, abs=2e-2)


def operator_cases() -> dict:
	"""Small operators of every module in ``operators/``, by id, as configurations: the two DIA kinds
	above; each configuration in ``BENCHMARK.json`` at its CPU size; each module's ``EXAMPLE``."""
	cases = {
		"path_laplacian-small": {"operator": "path_laplacian", "format": "dia", "params": PATH, "dtype": "float32"},
		"hofstadter-small": {"operator": "hofstadter", "format": "dia", "params": LATTICE, "dtype": "complex64"},
	}
	for entry in BENCH["configs"]:
		cfg = harness.load_json(harness.REPO / entry["file"])
		cases[f"{cfg['operator']}-{cfg['name']}"] = {**cfg, "params": {**cfg["params"], **cfg["cpu"]["params"]}}
	for kind in KINDS:
		example = getattr(harness.load_module("operators", kind), "EXAMPLE", None)
		if example is not None:
			cases[f"{kind}-example"] = {"operator": kind, **example}
	return cases


KINDS = sorted(p.stem for p in (harness.ROOT / "operators").glob("*.py") if not p.stem.startswith("_"))
CASES = operator_cases()


def test_every_operator_module_has_a_case():
	assert set(KINDS) <= {c["operator"] for c in CASES.values()}


@pytest.mark.parametrize("case", list(CASES))
def test_bands_handed_to_the_program_match_the_reference(case):
	"""The bands, tiles or entries the operator module builds, handed to the port's constructor of
	the format (by ``harness.FORMATS``), apply as the reference does."""
	import primate_tpu_torch as ptt

	cfg = CASES[case]
	dtype = getattr(torch, cfg["dtype"])
	fmt, parts = harness.operator_inputs(cfg, dtype, "cpu")
	op = getattr(ptt, fmt.program)(*parts)
	X = torch.randn(3, op.shape[0], dtype=dtype)
	ref = reference.operator(cfg, "float64", "cpu")
	want = ref.apply(X.to(ref.work))
	assert torch.allclose(op.matmat_t(X).to(ref.work), want, atol=1e-5)


@pytest.mark.parametrize("pdf,dtype", [("rademacher", torch.float32), ("rademacher", torch.complex64), ("phase", torch.complex64)])
def test_probes_are_the_programs_draw(pdf, dtype):
	from primate_tpu_torch.random import probe_dtype, sample_isotropic
	from primate_tpu_torch.trace import batch_generator

	seed = harness.call_seed(2**31 + 3, 7)
	for it in (0, 1):
		want = sample_isotropic(batch_generator(seed, it, "cpu"), (500, 4), pdf=pdf, dtype=probe_dtype(dtype, pdf)).T
		ref = reference.operator({"operator": "path_laplacian", "params": {"n": 500}, "dtype": str(dtype).removeprefix("torch.")}, "float64", "cpu")
		got = probes.draw(seed, it, 500, 4, pdf, ref.probe_dtype(pdf), "cpu")
		assert torch.equal(got, want)


def test_bf16_control_rounds_what_it_stores():
	ref = reference.operator({"operator": "hofstadter", "params": LATTICE, "dtype": "complex64"}, "bfloat16", "cpu")
	x = torch.tensor([1 + 1e-3j, 0.1 + 0.3j], dtype=torch.complex64)
	r = ref.rnd(x)
	assert torch.equal(r.real, x.real.to(torch.bfloat16).float()) and torch.equal(r.imag, x.imag.to(torch.bfloat16).float())
	assert ref.work == torch.complex64
