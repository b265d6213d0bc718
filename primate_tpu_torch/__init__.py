"""primate_tpu_torch — the PyTorch / CUDA port of primate_tpu, for NVIDIA Hopper (H100).

The JAX package ``primate_tpu`` is the reference; this package ports its main
path, stochastic Lanczos quadrature on a banded operator::

    L = DIAOperator.from_scipy(A, device="cuda")
    hutch(MatrixFunction(L, "log", deg=20, orth=0), batch=64, converge="count", count=64)

On the card the DIA stencil and the Lanczos step run hand-written CUDA kernels
(``csrc/``, built with nvcc at first use); on CPU tensors their plain PyTorch
versions run. This package imports neither ``jax`` nor ``primate_tpu``.
"""

from .convert import cov_state_from_numpy, dia_from_numpy
from .lanczos import lanczos_block_op
from .operators import DIAOperator, MatrixFunction
from .random import sample_isotropic
from .trace import hutch
from .tridiag import eigh_tridiag

__version__ = "0.1.0"

__all__ = [
	"hutch",
	"MatrixFunction",
	"DIAOperator",
	"lanczos_block_op",
	"eigh_tridiag",
	"sample_isotropic",
	"dia_from_numpy",
	"cov_state_from_numpy",
]
