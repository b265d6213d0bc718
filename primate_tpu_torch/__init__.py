"""primate_tpu_torch — the PyTorch / CUDA port of primate_tpu, for NVIDIA Hopper (H100).

The JAX package ``primate_tpu`` is the reference; this package ports two of
its paths. Stochastic Lanczos quadrature on a banded operator::

    L = DIAOperator.from_scipy(A, device="cuda")
    hutch(MatrixFunction(L, "log", deg=20, orth=0), batch=64, converge="count", count=64)

and the sketch trace and diagonal estimators on block-sparse and banded operators::

    S = BSROperator.from_scipy(A, blocksize=(8, 8), device="cuda")
    hutchpp(S, m=240); xtrace(S, batch=64, converge="count", count=256); xnystrace(S, m=720)
    xdiag(S, m=256); diagpp(S, m=240); diag(S, batch=64, converge="count", count=256)

On the card the DIA stencils, the Lanczos step and the BSR SpMM run
hand-written CUDA kernels (``csrc/``, built with nvcc at first use); on CPU
tensors their plain PyTorch versions run. This package imports neither
``jax`` nor ``primate_tpu``.
"""

from .convert import bsr_from_numpy, cov_state_from_numpy, dia_from_numpy
from .diagonal import diag, diagpp, xdiag
from .lanczos import lanczos_block_op
from .operators import BSROperator, DeflatedOperator, DIAOperator, MatrixFunction
from .random import sample_isotropic
from .trace import hutch, hutchpp, xnystrace, xtrace
from .tridiag import eigh_tridiag

__version__ = "0.1.0"

__all__ = [
	"hutch",
	"hutchpp",
	"xtrace",
	"xnystrace",
	"diag",
	"diagpp",
	"xdiag",
	"MatrixFunction",
	"DIAOperator",
	"BSROperator",
	"DeflatedOperator",
	"lanczos_block_op",
	"eigh_tridiag",
	"sample_isotropic",
	"dia_from_numpy",
	"bsr_from_numpy",
	"cov_state_from_numpy",
]
