"""The port's namespace against the JAX package's: every name of ``primate_tpu.__all__``
is an attribute of ``primate_tpu_torch`` or stands in ``NOT_YET_PORTED``, the port's
checklist against the reference; no name there is one the port already has."""

import pytest

import primate_tpu as pt
import primate_tpu_torch as ptt

# Each queue-A slice of the port takes its names off this list; every name is ported now.
NOT_YET_PORTED = set()


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
	"""Name by name, a branch of the JAX package that the port has not taken raises
	``NotImplementedError``: ``differentiable=True`` on a Hermitian operator, and the complex Lanczos-step kernels (ROADMAP B.7; the
	dtype rule the wrappers apply to a CUDA tensor, checked here without a card)."""
	import torch

	from primate_tpu_torch.ops._common import check_cuda

	calls = {
		"complex_hutch": lambda: ptt.hutch(_hermitian_op(), converge="count", count=4, differentiable=True),
		"complex_sketch": lambda: ptt.hutchpp(_hermitian_op(), m=3, differentiable=True),
		"complex_diag": lambda: ptt.diag(_hermitian_op(), converge="count", count=2, differentiable=True),
		"complex_kpm_trace": lambda: ptt.kpm_trace(_hermitian_op(), m=4, interval=(0.0, 2.0), differentiable=True),
		"complex_step_kernels_on_the_card": lambda: check_cuda("lanczos_dia_step", torch.complex128, torch.device("cuda", 0)),
	}
	with pytest.raises(NotImplementedError):
		calls[branch]()
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
