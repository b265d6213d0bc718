"""primate_tpu_torch — the PyTorch / CUDA port of primate_tpu, for NVIDIA Hopper (H100).

The JAX package ``primate_tpu`` is the reference; this package ports its
operators, Lanczos, quadrature, matrix functions and estimators. Stochastic
Lanczos quadrature on a banded operator::

    L = DIAOperator.from_scipy(A)
    hutch(MatrixFunction(L, "log", deg=20, orth=0), batch=64, converge="count", count=64)

on any scipy sparse matrix (a graph Laplacian becomes a ``CSROperator``), with
f(A)v and a stacked family of functions from one sweep::

    hutch(MatrixFunction(L_scipy, "log", deg=20, orth=5), batch=64, converge="count", count=64)
    MatrixFunction(L, "exp", t=-1.0, orth=0).matmat(V)
    hutch(MatrixFunction(L, stacked("exp", -taus), orth=0), batch=32, converge="count", count=32)

and the sketch trace and diagonal estimators on block-sparse and banded operators::

    S = BSROperator.from_scipy(A, blocksize=(8, 8))
    hutchpp(S, m=240); xtrace(S, batch=64, converge="count", count=256); xnystrace(S, m=720)
    xdiag(S, m=256); diagpp(S, m=240); diag(S, batch=64, converge="count", count=256)

Hermitian (complex) operators, unit-phase probes, the kernel polynomial method
and spectral densities, as on a tight-binding Hamiltonian with Peierls phases::

    H = DIAOperator.from_scipy(H_scipy, dtype=torch.complex64)
    kpm_density(H, grid=512, m=512, nv=16, pdf="phase", interval="gershgorin")
    diag(ChebyshevFunction(H, window, deg=256), pdf="phase", batch=16, converge="count", count=64)
    spectral_density(H, deg=64, nv=16)

spectra of rectangular data through its Gram operator (Golub-Kahan quadrature), its
singular triplets and low-rank factors, and eigenpairs at the ends of a spectrum or in
a slice of it::

    X = ComposedOperator(L, Rt) + sigma * BSROperator.from_scipy(G, blocksize=(8, 8))
    hutch(MatrixFunction(GramOperator(X), "sqrt"), batch=16, converge="count", count=16)
    svds(X, k=6); rsvd(X, k=6, n_iter=2); lanczos_bidiag(X, deg=64)
    eigsh(L, k=8, which="SA"); filtered_eigsh(L, (a, b), k=count)
    op, info = auto_operator(A_scipy)                        # DIA after RCM, BSR or CSR

and the Gaussian-process loss with its gradient, through batched CG and the
differentiable spectral sums (autograd through the CUDA kernels)::

    K = DIAOperator(bands_of(theta), offsets, (n, n))       # bands computed from theta
    nll = 0.5 * (autodiff.logdet(K, nv=128, chunk=64) + y @ solve(K, y) + n * log(2 pi))
    nll.backward()                                           # theta.grad

Every constructor and entry point that takes a ``device`` puts its tensors on
the card (``"cuda"``) unless the caller passes ``device="cpu"``; without a card
that default raises as torch does. A dense numpy or scipy matrix becomes an
operator on the card too (``MatrixFunction(A, device="cpu")`` or a CPU tensor
keeps it on the CPU), and the estimators follow their operator's device.
On the card the DIA stencils (real and complex), the Lanczos step and the BSR
SpMM run hand-written CUDA kernels (``csrc/``, built with nvcc at first use); on CPU
tensors their plain PyTorch versions run. The CSR apply is cuSPARSE's SpMM
through ``torch.sparse``. This package imports neither ``jax`` nor ``primate_tpu``.
"""

from . import autodiff, block_krylov, eigen, kpm, native
from .autodiff import spectral_sum
from .bidiag import lanczos_bidiag
from .block_krylov import block_lanczos, block_quadrature, block_slq_trace
from .convert import (
	bsr_from_numpy,
	coo_from_numpy,
	cov_state_from_numpy,
	csr_from_numpy,
	dia_from_numpy,
	diag_precond_from_numpy,
	nystrom_from_numpy,
)
from .density import cumulative_spectral_density, spectral_density, spectral_quantile
from .diagonal import diag, diagpp, xdiag
from .eigen import eigsh, filtered_eigsh, rand_nystrom, rsvd, svds
from .estimators import (
	ConfidenceCriterion,
	ConfidenceEstimator,
	ControlVariableEstimator,
	ConvergenceCriterion,
	CountCriterion,
	EstimatorResult,
	KneeCriterion,
	MeanEstimator,
	ToleranceCriterion,
	convergence_criterion,
)
from .fttr import fttr, ortho_poly
from .integrate import lanczos_quadrature, lobatto_rule, quadrature, radau_rule
from .kpm import ChebyshevFunction, kpm_density, kpm_trace, suggest_chebyshev_degree
from .lanczos import OrthogonalPolynomialBasis, lanczos, lanczos_block, lanczos_block_op, rayleigh_ritz
from .operators import (
	BSROperator,
	COOOperator,
	ComposedOperator,
	CSROperator,
	DeflatedOperator,
	DenseOperator,
	DIAOperator,
	FunctionOperator,
	GramOperator,
	MatrixFunction,
	PrepInfo,
	Toeplitz,
	aslinop,
	auto_operator,
	is_linear_op,
	is_valid_operator,
	matrix_function,
	normalize_unit,
)
from .random import Isotropic, haar, hermitian, isotropic, sample_isotropic, symmetric
from .solvers import NystromPreconditioner, cg, nystrom_precond, solve
from .special import param_callable, stacked
from .trace import hutch, hutchpp, xnystrace, xtrace
from .tridiag import eigh_tridiag, eigvalsh_tridiag, tqli

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
	"matrix_function",
	"DIAOperator",
	"GramOperator",
	"DenseOperator",
	"ComposedOperator",
	"Toeplitz",
	"normalize_unit",
	"auto_operator",
	"PrepInfo",
	"BSROperator",
	"CSROperator",
	"COOOperator",
	"DeflatedOperator",
	"FunctionOperator",
	"aslinop",
	"lanczos",
	"lanczos_block",
	"lanczos_block_op",
	"lanczos_bidiag",
	"block_lanczos",
	"block_quadrature",
	"block_slq_trace",
	"eigsh",
	"filtered_eigsh",
	"svds",
	"rsvd",
	"rand_nystrom",
	"rayleigh_ritz",
	"OrthogonalPolynomialBasis",
	"quadrature",
	"lanczos_quadrature",
	"radau_rule",
	"lobatto_rule",
	"fttr",
	"ortho_poly",
	"eigh_tridiag",
	"eigvalsh_tridiag",
	"tqli",
	"stacked",
	"param_callable",
	"MeanEstimator",
	"ConfidenceEstimator",
	"ControlVariableEstimator",
	"sample_isotropic",
	"Isotropic",
	"isotropic",
	"symmetric",
	"haar",
	"hermitian",
	"ChebyshevFunction",
	"kpm_trace",
	"kpm_density",
	"suggest_chebyshev_degree",
	"spectral_density",
	"cumulative_spectral_density",
	"spectral_quantile",
	"dia_from_numpy",
	"bsr_from_numpy",
	"csr_from_numpy",
	"coo_from_numpy",
	"cov_state_from_numpy",
	"nystrom_from_numpy",
	"diag_precond_from_numpy",
	"ConvergenceCriterion",
	"CountCriterion",
	"ToleranceCriterion",
	"ConfidenceCriterion",
	"KneeCriterion",
	"EstimatorResult",
	"convergence_criterion",
	"is_linear_op",
	"is_valid_operator",
	"cg",
	"solve",
	"nystrom_precond",
	"NystromPreconditioner",
	"spectral_sum",
	"autodiff",
	"kpm",
	"block_krylov",
	"eigen",
	"native",
]
