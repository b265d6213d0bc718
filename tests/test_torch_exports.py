"""The port's namespace against the JAX package's: every name of ``primate_tpu.__all__``
is an attribute of ``primate_tpu_torch`` or stands in ``NOT_YET_PORTED``, the port's
checklist against the reference; no name there is one the port already has."""

import pytest

import primate_tpu as pt
import primate_tpu_torch as ptt

# Each queue-A slice of the port takes its names off this list.
NOT_YET_PORTED = {
	"ChebyshevFunction", "Toeplitz", "auto_operator", "block_lanczos", "block_quadrature", "block_slq_trace",
	"eigsh", "filtered_eigsh", "hermitian", "kpm_density", "kpm_trace", "lanczos_bidiag", "lanczos_block",
	"normalize_unit", "rand_nystrom", "rsvd", "suggest_chebyshev_degree", "svds",
}


@pytest.mark.parametrize("name", sorted(pt.__all__))
def test_each_reference_name_is_ported_or_listed(name):
	if name in NOT_YET_PORTED:
		assert not hasattr(ptt, name), f"{name} is ported: take it off NOT_YET_PORTED"
	else:
		assert hasattr(ptt, name), f"primate_tpu_torch lacks {name}: port it or list it in NOT_YET_PORTED"


def test_the_checklist_names_only_reference_names():
	assert NOT_YET_PORTED <= set(pt.__all__)
	from primate_tpu_torch import CountCriterion, EstimatorResult, cg, solve, spectral_sum  # noqa: F401
