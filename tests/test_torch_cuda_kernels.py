"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips without a CUDA device. Imports no JAX (the
card's machine has none). Run on the card with ``python -m pytest -m cuda tests/test_torch_cuda_kernels.py``.
"""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

from primate_tpu_torch import DIAOperator, MatrixFunction, hutch
from primate_tpu_torch.ops import dia

torch.set_num_threads(1)
pytestmark = pytest.mark.cuda

SHAPES = [(64, 20_000, (-1, 0, 1)), (13, 3001, (-200, -7, 0, 7, 200)), (1, 5, (-9, 0, 2))]
# Stencil: max-abs error over max|out|. α: relative, since the summation orders differ.
TOL = {torch.float32: (1e-5, 1e-4), torch.float64: (1e-12, 1e-10)}


@pytest.fixture
def cuda():
	if not torch.cuda.is_available():
		pytest.skip("needs a CUDA device")
	return torch.device("cuda", 0)


def _inputs(dev, nv, n, offsets, dtype, seed=0):
	g = torch.Generator(device=dev)
	g.manual_seed(seed)
	bands = torch.rand((len(offsets), n), generator=g, device=dev, dtype=dtype) + 0.5
	offs = torch.tensor(offsets, dtype=torch.int64, device=dev)
	unit = lambda X: X / torch.linalg.vector_norm(X, dim=1, keepdim=True)  # noqa: E731
	x = torch.randn((nv, n), generator=g, device=dev, dtype=dtype)
	q_cur = unit(torch.randn((nv, n), generator=g, device=dev, dtype=dtype))
	q_prev = unit(torch.randn((nv, n), generator=g, device=dev, dtype=dtype))
	beta = torch.rand(nv, generator=g, device=dev, dtype=dtype) + 0.5
	return bands, offs, x, q_cur, q_prev, beta


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", SHAPES)
def test_kernels_match_plain_versions(cuda, shape, dtype):
	tol_s, tol_a = TOL[dtype]
	bands, offs, x, q_cur, q_prev, beta = _inputs(cuda, *shape, dtype)
	before = dict(dia.LAUNCHES)
	got, want = dia.dia_stencil_t(bands, offs, x), dia.dia_stencil_t_ref(bands, offs, x)
	v, alpha = dia.lanczos_dia_step(bands, offs, q_cur, q_prev, beta)
	v_ref, alpha_ref = dia.lanczos_dia_step_ref(bands, offs, q_cur, q_prev, beta)
	torch.cuda.synchronize()
	assert dia.LAUNCHES["dia_stencil_t"] == before["dia_stencil_t"] + 1
	assert dia.LAUNCHES["lanczos_dia_step"] == before["lanczos_dia_step"] + 1
	assert float((got - want).abs().max()) <= tol_s * float(want.abs().max())
	assert float((v - v_ref).abs().max()) <= tol_s * float(v_ref.abs().max())
	assert float(((alpha - alpha_ref).abs() / alpha_ref.abs()).max()) <= tol_a


def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
	bands, offs, x, q_cur, q_prev, beta = _inputs(cuda, 4, 100, (-1, 0, 1), torch.float32)
	with pytest.raises(TypeError):
		dia.dia_stencil_t(bands, offs, x.double())
	with pytest.raises(TypeError):
		dia.dia_stencil_t(bands.bfloat16(), offs, x.bfloat16())
	with pytest.raises(NotImplementedError):
		dia.dia_stencil_t(bands.to(torch.complex64), offs, x.to(torch.complex64))
	with pytest.raises(ValueError, match="contiguous"):
		dia.dia_stencil_t(bands, offs, torch.randn((100, 4), device=cuda).T)
	with pytest.raises(ValueError):
		dia.lanczos_dia_step(bands, offs.cpu(), q_cur, q_prev, beta)


def test_slq_on_the_card_matches_the_cpu_port(cuda):
	"""The whole slice, f64, the same numpy probes on both devices."""
	n = 5000
	L = sps.diags([-np.ones(n - 1), 3.0 * np.ones(n), -np.ones(n - 1)], [-1, 0, 1]).tocsr()

	def sampler():
		rng = np.random.default_rng(3)
		return lambda size: rng.choice([-1.0, 1.0], size=size)

	kw = dict(fun="log", deg=20, orth=0)
	dia.reset_launches()
	got = hutch(MatrixFunction(DIAOperator.from_scipy(L, device=cuda), **kw), batch=16, converge="count", count=32, pdf=sampler())
	assert dia.LAUNCHES["lanczos_dia_step"] == 20 * 2
	want = hutch(MatrixFunction(DIAOperator.from_scipy(L), **kw), batch=16, converge="count", count=32, pdf=sampler())
	np.testing.assert_allclose(got, want, rtol=1e-10)
