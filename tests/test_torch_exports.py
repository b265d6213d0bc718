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


@pytest.mark.parametrize("branch", ["filtered_eigsh_k_none", "complex_hutch", "complex_sketch", "complex_diag", "complex_kpm_trace",
	"complex_bsr_on_the_card", "complex_step_kernels_on_the_card"])
def test_each_unported_branch_raises(branch):
	"""Name by name, a branch of the JAX package that the port has not taken raises
	``NotImplementedError``: ``filtered_eigsh`` without ``k``, which counts the slice with
	``recipes.eigencount`` (ROADMAP A.10), ``differentiable=True`` on a
	Hermitian operator, and the complex BSR and Lanczos-step kernels (ROADMAP B.7; the
	dtype rule the wrappers apply to a CUDA tensor, checked here without a card)."""
	import torch

	from primate_tpu_torch.ops._common import check_cuda

	calls = {
		"filtered_eigsh_k_none": lambda: ptt.filtered_eigsh(_hermitian_op(), (0.8, 1.2), spectral_interval=(0.0, 2.0)),
		"complex_hutch": lambda: ptt.hutch(_hermitian_op(), converge="count", count=4, differentiable=True),
		"complex_sketch": lambda: ptt.hutchpp(_hermitian_op(), m=3, differentiable=True),
		"complex_diag": lambda: ptt.diag(_hermitian_op(), converge="count", count=2, differentiable=True),
		"complex_kpm_trace": lambda: ptt.kpm_trace(_hermitian_op(), m=4, interval=(0.0, 2.0), differentiable=True),
		"complex_bsr_on_the_card": lambda: check_cuda("bsr_spmm", torch.complex64, torch.device("cuda", 0)),
		"complex_step_kernels_on_the_card": lambda: check_cuda("lanczos_dia_step", torch.complex128, torch.device("cuda", 0)),
	}
	with pytest.raises(NotImplementedError):
		calls[branch]()
	# The two DIA stencils take complex tensors on the card.
	check_cuda("dia_stencil_t", torch.complex64, torch.device("cuda", 0), complex_ok=True)

