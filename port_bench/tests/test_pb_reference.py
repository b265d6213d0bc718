"""The plain reference against closed forms, against the bands the program is handed, and its probes
against the program's own draw."""

import numpy as np
import pytest
import torch

from port_bench import harness, reference
from port_bench.reference import chebyshev, hofstadter, lanczos, path_laplacian, probes

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


@pytest.mark.parametrize("kind,params,dtype", [("path_laplacian", PATH, torch.float32), ("hofstadter", LATTICE, torch.complex64)])
def test_bands_handed_to_the_program_match_the_reference(kind, params, dtype):
	import primate_tpu_torch as ptt

	bands, offsets, shape = harness.load_module("operators", kind).bands(params, dtype, "cpu")
	op = ptt.DIAOperator(bands, offsets, shape)
	X = torch.randn(3, shape[0], dtype=dtype)
	ref = reference.operator({"operator": kind, "params": params, "dtype": str(dtype).removeprefix("torch.")}, "float64", "cpu")
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
