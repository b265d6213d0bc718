"""Edge shapes and degenerate inputs of the port (``tests/test_edge_cases.py``), on the CPU.

Every case of the JAX suite that applies to the port, with the JAX suite's limits; the cases live in
``tests/torch_cases.py``, which ``chip_smoke.py`` runs on the card. Left out: its executable-cache count
(``test_block_lanczos_no_recompile_across_matrices``), which counts XLA compilations; the port compiles
nothing per operator. Where the JAX package refuses with an ``AssertionError`` the port raises
``ValueError``, so these cases assert the refusal. The JAX suite's float32 scipy bridge runs in a
subprocess with x64 off; here the operator's dtype is float32 itself. The last cases run DIA operators
of 1 and 3 rows through the stencils' and the step passes' plain versions, the shapes at which the
card's kernels are held to them.
"""

import pytest
import torch

from torch_cases import EDGE_CASES

torch.set_num_threads(1)


@pytest.mark.parametrize("case", list(EDGE_CASES))
def test_edge_case(case):
	EDGE_CASES[case]("cpu")
