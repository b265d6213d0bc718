"""The port's whole slice — hutch over MatrixFunction over DIAOperator — against
the JAX package, plus resume, the no-JAX import rule and the GPU smoke script's
refusal to run without a card."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import primate_tpu as pt
from primate_tpu.operators.sparse import DIAOperator as JaxDIA
from primate_tpu_torch import DIAOperator, MatrixFunction, hutch, sample_isotropic
from primate_tpu_torch.trace import batch_generator

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _path_laplacian(n):
	return sps.diags([-np.ones(n - 1), 3.0 * np.ones(n), -np.ones(n - 1)], [-1, 0, 1]).tocsr()


def _rademacher_sampler(seed):
	rng = np.random.default_rng(seed)

	def pdf(size):
		return rng.choice([-1.0, 1.0], size=size)

	return pdf


def test_slq_logdet_slice_matches_jax():
	"""bench.py's flagship at n = 2000, f64, each package drawing its probes from
	its own numpy sampler built from the same seed."""
	n = 2000
	L = _path_laplacian(n)
	kw = dict(batch=8, converge="count", count=32)
	got, res = hutch(MatrixFunction(DIAOperator.from_scipy(L, device="cpu"), "log", deg=20, orth=0), pdf=_rademacher_sampler(11), full=True, **kw)
	want = pt.hutch(pt.MatrixFunction(JaxDIA.from_scipy(L), "log", deg=20, orth=0), pdf=_rademacher_sampler(11), **kw)
	assert res.nit == 32
	np.testing.assert_allclose(got, want, rtol=1e-10, atol=0)
	k = np.arange(1, n + 1)
	exact = float(np.sum(np.log(3.0 - 2.0 * np.cos(k * np.pi / (n + 1)))))
	assert abs(got - exact) / exact < 0.05


def test_resume_continues_the_same_probe_stream():
	M = MatrixFunction(DIAOperator.from_scipy(_path_laplacian(500), device="cpu"), "log", deg=12, orth=0)
	fresh, fres = hutch(M, batch=8, converge="count", count=64, seed=5, full=True)
	_, half = hutch(M, batch=8, converge="count", count=32, seed=5, full=True)
	resumed, rres = hutch(M, batch=8, converge="count", count=64, seed=5, full=True, resume=half)
	assert half.nit == 32 and rres.nit == fres.nit == 64
	assert resumed == fresh  # bitwise: the same batches merged in the same order
	assert torch.equal(rres.estimator.state.S, fres.estimator.state.S)
	# A different seed draws different probes.
	assert hutch(M, batch=8, converge="count", count=64, seed=6) != fresh


def test_plain_trace_and_adaptive_criterion():
	"""hutch on the DIA operator itself (the stencil through quad_form), under the
	confidence criterion, which reads the running variance once per batch."""
	n = 4000
	op = DIAOperator.from_scipy(_path_laplacian(n), device="cpu")
	est, res = hutch(op, batch=16, converge="confidence", atol=40.0, rtol=0.0, seed=3, full=True)
	sigma = np.sqrt(res.estimator.converged_variance / res.nit)
	assert res.nit % 16 == 0 and 16 < res.nit < 1024
	assert abs(est - 3.0 * n) <= 5 * sigma  # tr(L) = 3n
	assert "CI" in res.message


def test_sample_isotropic_is_isotropic_and_probe_major():
	g = batch_generator(0, 0, "cpu")
	for pdf in ("rademacher", "normal", "sphere"):
		V = sample_isotropic(g, (400, 300), pdf=pdf, dtype=torch.float64)
		assert V.shape == (400, 300) and V.T.is_contiguous()
		cov = (V @ V.T / 300).numpy()  # E[v vᵀ] = I
		assert abs(np.mean(np.diag(cov)) - 1.0) < 0.05
		assert np.abs(cov - np.diag(np.diag(cov))).max() < 0.4
	R = sample_isotropic(g, (50, 7), pdf="rademacher")
	assert set(R.unique().tolist()) <= {-1.0, 1.0}
	S = sample_isotropic(g, (50, 7), pdf="sphere", dtype=torch.float64)
	np.testing.assert_allclose(torch.linalg.vector_norm(S, dim=0).numpy(), np.sqrt(50), rtol=1e-12)


def test_dense_operator_and_key_style_pdf():
	"""A dense matrix lifts to a DenseOperator; a ``(generator, shape, dtype)``
	callable draws the probes inside the batch loop."""
	rng = np.random.default_rng(9)
	Q, _ = np.linalg.qr(rng.normal(size=(60, 60)))
	ew = rng.uniform(0.5, 2.0, 60)
	A = (Q * ew) @ Q.T
	X = rng.choice([-1.0, 1.0], size=(60, 5))
	got = MatrixFunction(A, "log", deg=30, orth=30, device="cpu").quad(torch.from_numpy(X))
	want = pt.MatrixFunction(A, "log", deg=30, orth=30).quad(X)
	np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10, atol=0)

	def signs(generator, shape, dtype):
		return torch.randint(0, 2, shape, generator=generator, dtype=dtype) * 2 - 1

	est = hutch(torch.from_numpy(A), batch=20, pdf=signs, converge="count", count=2000, seed=1)
	assert abs(est - ew.sum()) < 5 * np.sqrt(2 * np.sum(A**2) / 2000)


def test_constructors_default_to_the_card():
	"""Every constructor that takes a device puts its tensors on the card unless the
	caller asks for the CPU (read from the signatures, so this holds with or without a card)."""
	import inspect

	from primate_tpu_torch import BSROperator, bsr_from_numpy, cov_state_from_numpy, dia_from_numpy
	from primate_tpu_torch.estimators import MeanEstimator
	from primate_tpu_torch.operators.base import DenseOperator, aslinop
	from primate_tpu_torch.stats import make_cov_state

	from primate_tpu_torch import (
		COOOperator,
		ConfidenceEstimator,
		CSROperator,
		Isotropic,
		coo_from_numpy,
		csr_from_numpy,
		haar,
		isotropic,
		cg,
		diag_precond_from_numpy,
		lanczos,
		nystrom_from_numpy,
		nystrom_precond,
		spectral_sum,
		symmetric,
	)
	from primate_tpu_torch.operators.base import AdjointOperator, AffineOperator, ComposedOperator, FunctionOperator, ScaledOperator

	fns = [DIAOperator.from_numpy, DIAOperator.from_scipy, BSROperator.from_numpy, BSROperator.from_scipy,
		BSROperator.from_dense, dia_from_numpy, bsr_from_numpy, cov_state_from_numpy, MeanEstimator, make_cov_state,
		DenseOperator, aslinop, MatrixFunction, CSROperator.from_numpy, CSROperator.from_scipy, CSROperator.from_dense,
		COOOperator.from_scipy, COOOperator.from_dense, csr_from_numpy, coo_from_numpy, FunctionOperator, AffineOperator,
		ScaledOperator, ComposedOperator, AdjointOperator, ConfidenceEstimator, Isotropic, isotropic, symmetric, haar, lanczos,
		cg, nystrom_precond, spectral_sum, nystrom_from_numpy, diag_precond_from_numpy]
	for fn in fns:
		assert inspect.signature(fn).parameters["device"].default == "cuda", fn
	# A tensor keeps its own device whatever the default; a numpy array goes where it is told.
	A = np.eye(3)
	assert aslinop(torch.from_numpy(A)).device.type == "cpu"
	assert aslinop(A, device="cpu").device.type == "cpu" and DenseOperator(A, device="cpu").device.type == "cpu"
	assert MatrixFunction(torch.from_numpy(A), "log").device.type == "cpu"
	# A scipy matrix goes where it is told, as a CSR operator; an operator keeps its device through the algebra.
	import scipy.sparse as sps

	op = aslinop(sps.identity(3, format="csr"), device="cpu")
	assert isinstance(op, CSROperator) and op.device.type == "cpu" and (2.0 * op + op).device.type == "cpu"


def test_import_leaves_jax_out():
	code = "import sys, primate_tpu_torch, primate_tpu_torch.ops.dia, primate_tpu_torch.ops.bsr, primate_tpu_torch.ops._build, " \
		"primate_tpu_torch.ops.autograd, primate_tpu_torch.solvers, primate_tpu_torch.autodiff, primate_tpu_torch.kpm, " \
		"primate_tpu_torch.density, primate_tpu_torch.operators.prepare, primate_tpu_torch.native, " \
		"primate_tpu_torch.bidiag, primate_tpu_torch.block_krylov, primate_tpu_torch.eigen; " \
		"bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'primate_tpu')]; print(bad); assert not bad"
	r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
	assert r.returncode == 0, r.stdout + r.stderr


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_refuses_without_the_card_or_the_repo(tmp_path, alone):
	"""Without a CUDA device (here), and in a directory holding the script alone,
	chip_smoke.py exits non-zero and prints no result line."""
	script = os.path.join(REPO, "chip_smoke.py")
	cwd = REPO
	if alone:
		shutil.copy(script, tmp_path / "chip_smoke.py")
		script, cwd = str(tmp_path / "chip_smoke.py"), str(tmp_path)
	env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
	r = subprocess.run([sys.executable, script], cwd=cwd, capture_output=True, text=True, timeout=120, env=env)
	assert r.returncode != 0
	assert '"ok"' not in r.stdout
