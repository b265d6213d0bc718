"""The port's namespace against the JAX package's: every name of ``primate_tpu.__all__``
is an attribute of ``primate_tpu_torch`` or stands in ``NOT_YET_PORTED``, the port's
checklist against the reference; no name there is one the port already has. The same,
name by name, for the ``__all__`` of every submodule of ``primate_tpu`` against the port's
module of the same name, with the TPU-only names and modules in ``NOT_PORTED``."""

import importlib
import pkgutil

import pytest

import primate_tpu as pt
import primate_tpu_torch as ptt

# Each queue-A slice of the port takes its names off this list; every name is ported now.
NOT_YET_PORTED = set()

# Names of the JAX submodules' __all__ that the port does not have, each with its reason.
NOT_PORTED = {
	("ops", "dia_matmat_pallas"): "the Pallas TPU kernel itself; the port's kernels are CUDA (csrc/), wrapped by ops.dia",
	("ops", "bsr_matmat_pallas"): "the Pallas TPU kernel itself; the port's kernels are CUDA (csrc/), wrapped by ops.bsr",
	("random", "as_key"): "a JAX PRNG key; the port draws from torch.Generator seeded by an int",
}
# JAX submodules with no port module of the same name, each with its reason.
NOT_PORTED_MODULES = {
	"ops.dia_pallas": "Pallas TPU kernels; ops.dia and csrc/dia_stencil.cu replace them",
	"ops.spmm_pallas": "a Pallas TPU kernel; ops.bsr and csrc/bsr_spmm.cu replace it",
}


def _jax_submodules() -> list:
	return sorted(m.name.removeprefix("primate_tpu.") for m in pkgutil.walk_packages(pt.__path__, "primate_tpu."))


def _submodule_names() -> list:
	"""(module, name) for every name of the ``__all__`` of each JAX submodule that has a port module."""
	return [(m, name) for m in _jax_submodules() if m not in NOT_PORTED_MODULES
		for name in getattr(importlib.import_module(f"primate_tpu.{m}"), "__all__", ())]


@pytest.mark.parametrize("name", sorted(pt.__all__))
def test_each_reference_name_is_ported_or_listed(name):
	if name in NOT_YET_PORTED:
		assert not hasattr(ptt, name), f"{name} is ported: take it off NOT_YET_PORTED"
	else:
		assert hasattr(ptt, name), f"primate_tpu_torch lacks {name}: port it or list it in NOT_YET_PORTED"


def test_the_checklist_names_only_reference_names():
	assert NOT_YET_PORTED <= set(pt.__all__)
	from primate_tpu_torch import CountCriterion, EstimatorResult, cg, solve, spectral_sum  # noqa: F401


def test_the_density_names_are_exported():
	for name in ("spectral_density", "cumulative_spectral_density", "spectral_quantile", "kpm"):
		assert hasattr(ptt, name), name


def _hermitian_op():
	import numpy as np
	import torch

	return torch.from_numpy(np.array(pt.hermitian(8, ew=np.linspace(0.5, 1.5, 8), seed=1)))


@pytest.mark.parametrize("branch", ["complex_hutch", "complex_sketch", "complex_diag", "complex_kpm_trace",
	"complex_step_kernels_on_the_card"])
def test_each_unported_branch_raises(branch):
	"""Name by name, a branch of the JAX package that the port does not take raises
	``NotImplementedError``: ``diag(differentiable=True)`` on a Hermitian operator (JAX refuses it too),
	and the complex Lanczos-step kernels (ROADMAP B.7; the dtype rule the wrappers apply to a CUDA
	tensor, checked here without a card). The other Hermitian ``differentiable=True`` branches are
	taken, as the JAX package takes them: ``hutch`` on a plain operator, the sketches and ``kpm_trace``
	return a tensor that carries a gradient (held to ``jax.grad`` in ``test_torch_complex_grad.py``)."""
	import torch

	from primate_tpu_torch.ops._common import check_cuda

	H = _hermitian_op().requires_grad_(True)
	calls = {
		"complex_hutch": lambda: ptt.hutch(H, converge="count", count=4, differentiable=True),
		"complex_sketch": lambda: ptt.hutchpp(H, m=3, differentiable=True),
		"complex_diag": lambda: ptt.diag(H, converge="count", count=2, differentiable=True),
		"complex_kpm_trace": lambda: ptt.kpm_trace(H, m=4, interval=(0.0, 2.0), differentiable=True),
		"complex_step_kernels_on_the_card": lambda: check_cuda("lanczos_dia_step", torch.complex128, torch.device("cuda", 0)),
	}
	if branch in ("complex_diag", "complex_step_kernels_on_the_card"):
		with pytest.raises(NotImplementedError):
			calls[branch]()
	else:
		est = calls[branch]()
		assert isinstance(est, torch.Tensor) and est.requires_grad and not est.is_complex()
		(g,) = torch.autograd.grad(est, H)
		assert g.dtype == torch.complex128 and bool(torch.all(torch.isfinite(torch.view_as_real(g))))
	# The two DIA stencils take complex tensors on the card.
	check_cuda("dia_stencil_t", torch.complex64, torch.device("cuda", 0), complex_ok=True)


@pytest.mark.parametrize("kernel,dtype", [("bsr_spmm", "complex64"), ("bsr_spmm", "complex128"), ("dia_stencil", "complex64")])
def test_complex_kernels_take_complex_tensors_on_the_card(kernel, dtype):
	"""The dtype rule of the wrappers that have complex instantiations (the two DIA stencils, and
	``bsr_spmm`` since its complex64/complex128 entry points): ``check_cuda(..., complex_ok=True)``
	accepts a complex tensor on a CUDA device, checked without a card."""
	import torch

	from primate_tpu_torch.ops._common import check_cuda

	check_cuda(kernel, getattr(torch, dtype), torch.device("cuda", 0), complex_ok=True)
	with pytest.raises(NotImplementedError):
		check_cuda(kernel, getattr(torch, dtype), torch.device("cuda", 0))



def _public_functions(module) -> set:
	return {n for n, v in vars(module).items() if not n.startswith("_") and callable(v) and getattr(v, "__module__", None) == module.__name__}


@pytest.mark.parametrize("module", ["recipes", "stats", "utils.checkpoint", "utils.profiling", "utils.kwargs", "plotting", "parallel"])
def test_module_names_match_jax(module):
	"""``recipes``, ``stats``, ``plotting`` and ``parallel`` by ``__all__``, the three ``utils`` modules by their public functions and classes."""
	import importlib

	jmod = importlib.import_module(f"primate_tpu.{module}")
	tmod = importlib.import_module(f"primate_tpu_torch.{module}")
	if hasattr(jmod, "__all__"):
		assert set(tmod.__all__) == set(jmod.__all__)
	assert _public_functions(tmod) == _public_functions(jmod)
	assert set(ptt.recipes.__all__) <= set(dir(ptt.recipes)) and ptt.utils.checkpoint is importlib.import_module("primate_tpu_torch.utils.checkpoint")


@pytest.mark.parametrize("module,name", _submodule_names())
def test_each_submodule_name_is_ported_or_listed(module, name):
	"""Each name of a JAX submodule's ``__all__`` is in the port's module of the same name and in its
	``__all__``, or stands in ``NOT_PORTED`` (and then the port lacks it)."""
	tmod = importlib.import_module(f"primate_tpu_torch.{module}")
	if (module, name) in NOT_PORTED:
		assert not hasattr(tmod, name), f"primate_tpu_torch.{module}.{name} exists: take it off NOT_PORTED"
	else:
		assert hasattr(tmod, name), f"primate_tpu_torch.{module} lacks {name}: port it or list it in NOT_PORTED"
		assert name in getattr(tmod, "__all__", (name,)), f"primate_tpu_torch.{module}.__all__ lacks {name}"


def test_the_not_ported_lists_name_jax_names_and_modules():
	mods = set(_jax_submodules())
	assert set(NOT_PORTED_MODULES) <= mods
	for m in mods - set(NOT_PORTED_MODULES):
		importlib.import_module(f"primate_tpu_torch.{m}")
	for m in NOT_PORTED_MODULES:
		with pytest.raises(ModuleNotFoundError):
			importlib.import_module(f"primate_tpu_torch.{m}")
	assert all(name in importlib.import_module(f"primate_tpu.{m}").__all__ for m, name in NOT_PORTED)


def test_sign_and_arr_summary_match_jax():
	import numpy as np
	import torch

	from primate_tpu import estimators as jest, tridiag as jtri
	from primate_tpu_torch import estimators as test_, tridiag as ttri

	a = np.array([-2.0, -0.5, 0.0, 0.5, 3.0, -1.0])
	b = np.array([1.0, -1.0, 0.0, 0.5, -0.0, 2.0])
	assert np.array_equal(ttri.sign(torch.from_numpy(a), torch.from_numpy(b)).numpy(), np.asarray(jtri.sign(a, b)))
	for x in (None, 1.5, np.array([1.0, 2.5]), np.linspace(0.0, 1.0, 9), torch.linspace(0.0, 1.0, 9, dtype=torch.float64)):
		assert test_.arr_summary(x) == jest.arr_summary(np.asarray(x) if isinstance(x, torch.Tensor) else x)


def test_integrate_spectral_density_is_the_density_alias():
	import numpy as np
	import torch

	A = torch.from_numpy(np.diag(np.linspace(0.5, 2.0, 24)))
	kw = dict(grid=16, deg=12, nv=4, seed=3)
	got, want = ptt.integrate.spectral_density(A, **kw), ptt.density.spectral_density(A, **kw)
	for g, w in zip(got, want):
		assert np.array_equal(np.asarray(g), np.asarray(w))


@pytest.mark.parametrize("kind", ["dia", "bsr"])
@pytest.mark.parametrize("single", [False, True])
def test_ops_matmat_matches_jax(kind, single):
	"""``ops.dia_matmat``/``ops.bsr_matmat`` against the JAX package's (its Pallas kernels in interpret
	mode, at a probe count that is a multiple of 128), on the same operator and block."""
	import numpy as np
	import scipy.sparse as sps
	import torch

	from primate_tpu import ops as jops
	from primate_tpu.operators import sparse as jsp

	rng = np.random.default_rng(7)
	n, k = 64, 128
	if kind == "dia":
		A = sps.diags([rng.normal(size=n - 3), rng.normal(size=n), rng.normal(size=n - 1)], [-3, 0, 1], format="csr")
		jop, top = jsp.DIAOperator.from_scipy(A), ptt.DIAOperator.from_scipy(A, device="cpu")
		jfn, tfn = jops.dia_matmat, ptt.ops.dia_matmat
	else:
		A = sps.random(n, n, density=0.1, random_state=3, format="csr") + sps.eye(n)
		jop, top = jsp.BSROperator.from_scipy(A, blocksize=(8, 8)), ptt.BSROperator.from_scipy(A, blocksize=(8, 8), device="cpu")
		jfn, tfn = jops.bsr_matmat, ptt.ops.bsr_matmat
	V = rng.normal(size=(n, k))
	want = np.asarray(jfn(jop, V, interpret=True))
	got = tfn(top, torch.from_numpy(V)).numpy()
	np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
	np.testing.assert_allclose(got, A @ V, rtol=1e-12, atol=1e-12)
	if single:
		np.testing.assert_allclose(tfn(top, torch.from_numpy(V[:, 0])).numpy(), want[:, 0], rtol=1e-12, atol=1e-12)
	with pytest.raises(TypeError):
		tfn(torch.from_numpy(A.toarray()), V)
