"""Run the PyTorch port's main path on one NVIDIA GPU and check its CUDA kernels.

    python3 chip_smoke.py

Builds the kernels of ``primate_tpu_torch/csrc`` with nvcc (sm_90a), then:

1. prints the card's name and power limit, and the build time;
2. holds each DIA kernel and the two passes of the Lanczos step against their
   plain PyTorch versions on the card, float32 and float64, at the flagship shape
   and at an awkward one, and times each at the flagship shape beside its bound
   and, where one PyTorch call computes the same function, that call (``library_ms``);
   then the two passes and ``lanczos_dia_advance`` on the padded carry (``DIAOperator.carry_spec``,
   the layout of ``lanczos_block_op(phys=True)`` and of the row-sharded sweep) at 64 × 500k and
   64 × 10M, in the row-sharded mode (each step's finish left for the next step's pass A, the last
   one run by the advance kernel), against their plain versions, the carry's margins exactly zero,
   pass A with a pending finish bit for bit the advance kernel and then pass A, each timed beside its
   plain version and bound, the advance split into host and device time a launch;
3. runs the flagship SLQ logdet (``bench.py``'s configuration) at n = 500,000 in
   float32: the estimate must be within 5% of the exact logdet, and both step
   kernels must have launched deg × batches times;
4. runs the same at n = 10,000,000 and reports wall time and peak memory;
5. runs the plain trace ``hutch(DIAOperator(L))`` at n = 500,000: within 5σ of
   tr(L) = 3n, through the stencil kernel;
6. holds the BSR SpMM and both DIA stencils against their plain versions, float32
   and float64, at the cell operators of phases 7 and 8 (k = 64 and 240; the
   probe-major stencil at the 64 × n block of phase 8's ``diag``) and at awkward
   shapes (for the probe-major stencil: offsets ±10,000, 64, 13 and 1 probes, and
   a misaligned block that takes its scalar path), and times kernel, plain
   version, bound, library call and (for the node-major stencil) the transpose
   route through the probe-major kernel; it runs last, on the operators that
   phases 7 and 8 built;
7. runs BASELINE config 3's sketch estimators (``benchmarks/configs.py:73-105``)
   on ``block_random_spd(n=1,048,576)`` as a BSR operator with 8×8 tiles, at
   the scale of the SuiteSparse matrix audikw_1: each trace within 1e-3 of
   tr(S), and the BSR kernel launched once per operator application;
8. runs Hutch++, XDiag, Diag++ and the Girard-Hutchinson diagonal on the 3-D FEM
   Laplacian ``fem_laplacian_3d(side=100)`` (n = 1,000,000, offsets ±1, ±100,
   ±10,000) as a DIA operator: trace within 1e-3, diagonals within 0.1 (relative L2),
   and ``diag`` launching the probe-major stencil once an iteration (256 times);
9. runs BASELINE config 2 in its CSR form: SLQ logdet (deg 20, orth 5, 64 probes)
   of ``powerlaw_laplacian(n=1,000,000)`` handed in as the scipy matrix itself,
   within ``0 ≤ logdet ≤ Σ log L_ii``, and the same call at n = 8,192 within 5% of
   the exact logdet; times one CSR apply at k = 64 in both layouts beside its bound;
10. runs BASELINE config 4: the heat-kernel curve ``tr exp(−τL)`` at 8 values of τ
   on the 1000×1000 mesh Laplacian (n = 1,000,000) as a DIA operator, from one
   sweep per batch: each within 2% of its closed form, both step kernels launched
   deg × batches times; and the same mesh as scipy CSR through phase 9's logdet
   call, within 5% of its closed form;
11. computes ``exp(−L)V`` for ``V (n, 8)`` on the mesh in one pass (a stored basis)
   and in two: each within 1e-4 (relative) of the exact ``e^{−1}·vec(E X E)``, and
   the step kernels launched deg and 2·deg times;
12. estimates the heat-kernel signature ``diag(exp(−τL))`` for the 8 values of τ:
   relative L2 error below 0.1 for every τ ≤ 1, the step kernels launched;
13. computes BASELINE config 5, the GP negative log-likelihood and its gradient, at
   n = 10,000,000 in float32: ``K(θ) = e^{θ₀}·T + e^{θ₁}·I`` (T the 1-D Dirichlet
   Laplacian) as a DIA operator whose bands are computed from θ = (0, 0),
   ``nll = ½(autodiff.logdet(K) + y·solve(K, y) + n log 2π)`` (128 probes in two
   chunks) and ``nll.backward()``: the logdet, ``yᵀK⁻¹y`` and both gradient components
   each within 1e-3 of their closed forms through T's DST-I eigenbasis, the step kernels
   launched in the forward pass and the probe-major stencil (CG, band pullback) in both;
   then each kernel and kernel Function of the path against its plain version on the
   run's own operator and blocks (the probe-major stencil at 64 × n and 1 × n, the
   node-major one at n × 1, both backwards), within the float32 kernel tolerance;
14. runs batched CG on phase 9's power-law graph with 64 Rademacher right-hand sides,
   Jacobi- and Nyström-preconditioned (rank 64, seeded): each converges (the recursive
   residual ``cg(full=True)`` reports, as in JAX, within rtol), and every column's
   ``‖B − AX‖/‖B‖``, computed apart in float64, is within 2·rtol; how far the reported
   residual drifts from the true one is printed;
15. runs ``examples/tight_binding.py`` on the Hofstadter model at 2000 × 2048 = 4,096,000
   sites (flux 1/5, periodic) as a complex64 DIA operator of 8 diagonals: the complex
   stencils against their plain versions, complex64 and complex128, at the cell's shapes
   and at awkward ones, timed beside bound, plain version and complex cuSPARSE; the complex
   step passes (``lanczos_dia_step``, ``lanczos_dia_residual``) against the plain step, complex64
   and complex128, two steps at the cell's 16 × n block (a probe broken down) and at awkward shapes
   (n odd, a misaligned block: complex64's scalar path; offsets inside, at and past 16 rows and at and
   past n; 9 and 12 diagonals; far offsets that are and are not whole 16-byte vectors; wrap offsets near
   ±n), pass A alone (its ``w`` the plain version's bit for bit), and passes A, B and the step timed at
   the cell beside bound and plain versions; then, each
   counted and timed, ``kpm_trace`` of x² and x⁴ against the closed forms 4n and
   (28 + 8 cos 2πα)·n (10 σ of its own probes), the KPM density (mass 1, second moment 4),
   Lanczos against Chebyshev quadrature probe for probe (1e-4; the Lanczos sweep 40 complex steps,
   passes A and B each, no ``dia_stencil_t``), the β sweep of ``tr e^{−βH}`` (48 steps a batch, the
   same; within 2% of the KPM density's), ``diag`` of H² (mean 4 within 1e-3, L2 error within 10% of
   its closed form), the LDOS window, the SLQ density (64 steps), Hutch++ of H·H (within 1e-2 of 4n; two node-major
   stencils for the QR block) and the same Chebyshev quadrature through complex CSR (1e-5);
16. builds the native loader (g++) and holds its DIA build of the 10M tridiagonal and its BSR
   build of phase 7's matrix to scipy's, bit for bit, each timed; runs ``auto_operator`` on a 1M
   path Laplacian in a seeded random order (DIA after RCM, bandwidth 1, then the flagship logdet
   on it within 5%, the step kernels launched deg times), on phase 9's graph (CSR) and on phase
   7's matrix (BSR), RCM tried and rejected on the last two;
17. runs ``eigsh`` on phase 10's mesh (LOBPCG LA and SA, thick-restart LA, k = 8), each pair
   within its float64 residual of the closed-form spectrum (Bauer-Fike); ``block_slq_trace`` of
   ``exp(−τL)`` at two τ within 2% (through the node-major stencil); ``normalize_unit`` mapping the
   mesh's extremes into [−1, 1]; ``filtered_eigsh`` on the 400 × 250 grid Laplacian of
   ``examples/spectrum_slicing.py`` (its lowest 48 pairs, each within 1e-4·max|λ|); ``Toeplitz``
   at 1M against the DIA path Laplacian (1e-4);
18. runs ``examples/rectangular_spectra.py`` at m = 1,048,576, n = 131,072 (X = L Rᵀ + σG, G a
   seeded BSR noise operator of about 42M nonzeros): the top 6 singular values by ``svds``,
   ``rsvd`` and ``lanczos_bidiag`` within 1e-4 of each other (svds's residuals ≤ 1e-3), ‖X‖²_F by
   Gram quadrature within 10σ of its exact value, the nuclear norm from both Gram sides within
   4σ of each other, the Gram density's mass within 1e-2, and ``bsr_spmm`` in both directions;
19. runs the recipes (``primate_tpu_torch.recipes``), each call timed and its launches counted,
   against closed forms: ``logdet`` on the 10M tridiagonal equal bit for bit to the flagship
   composition, and ``shifted_trace`` (the GP noise sweep at 8 shifts) within 5%, both 20 + 20
   step launches; on phase 10's mesh at their defaults (``orth=5``: pass A, no pass B) ``logdet``
   (1%), ``trace_bounds`` (the exact value within the bracket ± 4 standard errors),
   ``suggest_degree`` (gaps that do not grow), ``heat_kernel_trace`` (2%), ``effective_dim`` and
   ``schatten`` (1%), ``eigencount`` (5% of the closed-form smoothstep window), ``bilinear_form``
   at 8 node pairs (1e-5 of e^{−1/2}·E⊗E), ``weighted_trace`` (5σ) and ``suggest_probes``; on
   ``separated_spectrum`` ``slogdet`` of a shifted copy (sign −1, 3 negatives, 1%),
   ``condition_number`` (1e-4), ``deflated_trace`` (0.5%), ``topk`` (1e-4), ``trace_inv`` by SLQ
   and by Jacobi CG (1%) and ``tikhonov`` on 64 right-hand sides (float64 residuals ≤ 2·rtol,
   ``dia_stencil_t`` once an iteration); ``pagerank`` on phase 9's graph (float64 residuals);
   ``schatten(X, 2, gram=True)`` on phase 18's X (10σ); ``filtered_eigsh`` with no ``k`` on
   phase 17's grid (every pair of the window within 1e-4·max|λ|, its ``eigencount`` printed).
   First pass A and the stencils are held to their plain versions at this phase's shapes;
20. differentiates through the Lanczos recurrence on phase 10's mesh (n = 1,000,000, 5 diagonals,
   float32): ``F = Σ W∘MatrixFunction(L, exp(−x), deg=20, orth=0).matmat(V)`` for V, W of 64 probes
   (two sweeps), F at ``orth=5`` on 16 probes and ``Σ diag(MatrixFunction(L, "log"),
   differentiable=True)`` (4 × 16 probes), each with respect to the bands: its directional
   derivative along a seeded direction within 1e-4 of a float64 central difference, F's float32
   gradient within 1e-3 of its float64 one, ``dia_stencil_t`` once a step forward and once a step
   but the first backward, no step kernel; walls and peak memory. Then F through a BSR operator
   (``bsr_spmm`` forward and on the transposed tiles backward), held the same way;
21. runs Hutchinson (phase probes, within 5σ of tr H) and phase 7's sketches (within 1e-3) on
   H = A + i·s(B − Bᵀ), phase 7's cell A with a seeded real block operator B on its pattern, as a
   complex64 BSR operator (tr H = tr A), through the complex ``bsr_spmm``; its adjoint against the
   conjugate transpose; the complex64 kernel against its plain version at k = 64 and 240, timed
   beside its bound, plain version and library call, and complex128 at a small shape whose V fits in
   L2 (the L2 path: float64 MMAs, within 1e-14), with host and device time a call and complex64 there;
22. runs the five port examples (``primate_tpu_torch.examples``) at their own sizes, each with its
   checks against closed forms or a dense reference;
23. runs the sharded path (``primate_tpu_torch.parallel``). (a) One rank over NCCL, in this process:
   the 10M flagship through ``shard_operator(DIAOperator(L))`` at ``orth`` 0 and 5 against the
   unsharded operator on the same probes (α, β and the estimate within float32's 1e-4, the estimate
   within 5% of the exact logdet; the sharded sweep's step is the halo exchange and the step kernels
   on the padded carry: passes A and B deg times each and ``lanczos_dia_advance`` once, for the last
   step's finish, at ``orth = 0``; pass A deg times at 5; ``dia_stencil_t`` no time), walls and peak
   memory of both;
   ``lanczos_block_op(phys=True)`` on the 10M operator against the flat sweep (α, β within 1e-4);
   the sharded operator's global face in both layouts at the flagship shape (``dia_stencil_t``, on
   its vector path, and ``dia_stencil`` once each, equal to the unsharded applies); phase 7's
   sketches through ``ShardedBSROperator`` (within phase 7's limits, ``bsr_spmm`` once an apply) and
   phase 9's logdet through ``ShardedCSROperator`` (within its bounds). (b) Two ranks over gloo, both
   on cuda:0, as subprocesses of this script (``--sharded-rank``, meeting through a file store in a
   temporary directory; the collectives staged through host memory): the flagship at n = 500,000
   through the halo DIA operator and an allgather BSR one, each on (op, probe) meshes (2, 1) and (1, 2): both ranks' estimates equal bit for bit and within 5%,
   each rank's kernels launched (the DIA sweep: the step kernels, no ``dia_stencil_t``).
24. runs bfloat16, JAX's third operator dtype: each of the four kernels' bf16 instantiations
   (``dia_stencil_t``, pass A, ``dia_stencil``, ``bsr_spmm``) against its bf16 plain version at the
   path's shapes (bf16 outputs within one bf16 ulp of their largest entry, pass A's float32 w and α
   within 1e-5; rounded, w may differ by one bf16 ulp of a stencil sum on at most 1e-4 of its entries
   and lies nearer the rounded plain version than the unrounded one), timed beside its bound at 2-byte
   elements and the card's bf16 rate and beside its library call where torch
   takes bf16 (a refusal is printed), pass A and ``dia_stencil_t`` (their bf16 register kernels) also beside
   the times of the kernels they replaced, quoted from PERF.md (``predecessor_ms_quoted``); JAX's full-bf16 SLQ (a bf16 ``DIAOperator`` and
   ``MatrixFunction(..., dtype=bfloat16)``) at 500k and 10M beside the float32 flagship, each within 5%
   of the exact logdet, walls and peaks (the 10M bf16 peak below the float32 one); the plain trace on
   the bf16 DIA operator; a node-major apply of the bf16 FEM operator; the bf16 BSR trace on phase 7's
   cell within 1e-2 of the float32 one on the same probes; the sharded bf16 flagship on one NCCL rank at
   10M (within 1e-3 of the unsharded bf16 one) and on two gloo ranks at 500k (equal bit for bit). The
   round pair that finishes a bf16 step (``lanczos_dia_round``: B1 the norm, B2 the rounded q_next) is
   held to its plain version, the PyTorch tail it replaces, on pass A's output at 64 × 500k and 64 × 10M,
   flat and padded (α outputs and done flags equal, β' within 1e-6, q_next equal but for one-ulp flips
   on at most 1e-4 of its entries), B1, B2 and the pair timed beside their bounds and the tail; every
   full-bf16 sweep of the phase runs pass A and the pair once a step (the sharded ones too: B2 finishes
   their steps) and pass B and the advance never; the 10M and 500k wall and peak ratios against float32
   go out on lines of their own.
25. runs reverse mode on Hermitian operators (``differentiable=True``, as the JAX package differentiates
   them): (a) on phase 15's Hofstadter cell, the bands requiring a gradient, ``hutch`` (16 phase
   probes), ``kpm_trace`` of x² (3 undamped Chebyshev terms on (−4.5, 4.5)) and ``block_slq_trace`` of
   x² (b = 8, 2 steps, 2 blocks); (b) on phase 21's complex BSR cell, the tiles requiring a gradient,
   Hutch++, XTrace, XNysTrace and the sum of XDiag at phase 21's budgets. Each holds Euler's identity
   ``Σ Re(conj(g)·b) = p·estimate`` (p = 1, or 2 for x²) within 1e-5 of ``Σ|g|·|b|``, its value to its
   phase's limit (KPM within 5σ of tr H² = 4n), and its complex64 gradient within 1e-3 of the largest
   entry of a complex128 gradient of the same call on the same probes (the BSR sketches at smaller
   budgets). (c) Each complex kernel's backward (``dia_stencil_t`` at 16 × n and ``dia_stencil`` at n ×
   64 on the Hofstadter bands, ``bsr_spmm`` at the BSR cell with k = 64; complex64 and complex128; a
   misaligned block and lazy conjugate views in complex64) against autograd through its plain version,
   one launch a backward, timed beside it, with the time of the conjugated adjoint bands or tiles.
26. runs what the port lacked of the JAX package: (a) the gradient of ``Σ MatrixFunction(op, "log", deg=20,
   orth=0).quad(V)`` (64 Rademacher probes) to the bands of a batch of molecules, 100,000 disjoint 10-row
   chains tridiag(−1, 3, −1), float32, where every probe breaks down at step 10: finite, ⟨∂bands, bands⟩
   within 1e-4 of 64·n, two symmetric chain-preserving directional derivatives within 1e-3 of the float64
   closed form, ``dia_stencil_t`` 20 launches forward and 19 on the adjoint bands backward, the stencils held
   to their plain versions there; (b) every operator kind (DIA, CSR, COO, BSR 8×8, a ``FunctionOperator``
   around the DIA apply, ``AffineOperator``, an identity ``MatrixFunction`` at n = 1,048,576; a tensor and a
   ``DenseOperator`` at 8192) × ``hutch``, ``hutchpp``, ``xtrace``, ``diag``, ``xdiag``, ``lanczos`` and
   ``solve``: traces within 1e-3 of 3n, diagonals within 0.1, the residual below its rtol, the formats on
   the same probes within 1e-5 of each other, each format's kernels launched and no other; (c) the CPU
   edge cases (``tests/torch_cases.py``, which the CPU suites run too) with their tensors on the card, and DIA operators of 1 and 3 rows through both stencils and
   both step passes, each held to its plain version.
27. holds the JAX package's public contract on the card (``tests/test_torch_contract.py`` holds it on the CPU):
   (a) on phase 7's BSR cell, ``hutchpp(m=240, full=True)`` and ``xnystrace(m=720, full=True)`` keep 480 and 720
   per-probe estimates in ``result.samples`` and none in ``info``, their records unpack into six, XNysTrace's sample
   mean is its estimate within 1e-6 and its estimator tracks the variance; (b) on phase 8's FEM cell, ``diag(full=True)``
   with a callback: 256 callbacks that see one ``MeanEstimator`` (no variance), its estimate the returned array bit for
   bit, the criterion's message, ``info`` holding ``state`` alone; ``record=True`` at 4 iterations keeps 4·n values in
   ``result.estimator.values``; ``resume`` from that record to 8 iterations equals a direct run bit for bit; (c) the four
   special functions given 1M float32 nodes on the card: equal to their closures bit for bit, on the card, within 64
   float32 ulps of a float64 numpy evaluation; a smoothstep closure through SLQ on the 500k flagship operator within 1%
   of its closed form, passes A and B 40 times each (a one-probe sweep sizes the closure's output); (d) ``DIAOperator.from_dense`` of a dense 8192² pentadiagonal: the
   bands and offsets of ``from_scipy``, and the same SLQ logdet bit for bit; (e) ``MeanEstimator(covariance=True)`` on
   the card fed the flagship's 64 per-probe samples: numpy's ``var(ddof=1)`` within 1e-6, and None without the flag.
28. runs the re-orthogonalised cell's configuration (``port_bench/traffic/slq_logdet_orth5.json``): (a) the SLQ logdet
   at ``orth = 5``, ``reorth_passes = 2`` on the 10M path Laplacian (64 probes, float32), counted from zero: within 5%
   of the exact logdet, pass A and the CGS window's chain (``cgs_window``) 20 times each, no scalar launch, no pass B;
   (b) the chain against its plain version (``ops.cgs.cgs_window_ref``, the PyTorch ops it replaced) on the same
   inputs at that shape (64 × 10M, a window of 5 unit slots, q_cur the window's own slot), at the full window and at a
   partial one (2 slots), within 1e-5 (max |Δv| over max |v|, and Σ|v|² relative), one launch counted each, each
   timed beside its plain version and its bound, (3s + 6)·nv·n·4 bytes at s slots over the HBM rate.

Phase 6 ends with the backward check: each kernel's ``torch.autograd.Function``
(``primate_tpu_torch/ops/autograd.py``) against autograd through its plain version, float32
and float64, at phase 6's cell shapes, on non-symmetric bands and on a misaligned block,
its backward timed beside the plain version's.

Each phase raises on failure. Measured values go out as JSON lines; the line
before the last lists every kernel with its launches on its path, its error
against its plain version, its time, its plain version's time, its bound
(``bound_ms``: the larger of its bytes over the HBM rate and its flops over the
float32 rate, the bf16 rate for bf16 operands) and its library call's time (``library_ms``, null where no single
call computes it); for ``dia_stencil_t`` the same numbers at the FEM ``diag``
shape follow under ``fem_`` keys, with its launches in that call
(``fem_launches``), and its float64 numbers at the flagship shape under ``f64_`` keys; the three kernels with a backward carry its error
(``grad_max_abs_err``, over float32 and float64, relative to the largest entry) and
times (``backward_ms``, ``backward_plain_ms``), and the three kernels of phase 13 their
launches in its forward and backward passes (``gp_forward_launches``,
``gp_backward_launches``), and the two stencils and the two step passes their complex64 numbers at
phase 15's cell shapes under ``c64_`` keys (the passes and the stencils their complex128 ones under ``c128_``), with
``c64_launches`` the complex launches of its calls 2-8;
every kernel also carries its launches in phases 16, 17, 18, 19 and 22 (``prep_launches``,
``eig_launches``, ``gram_launches``, ``recipe_launches``, ``example_launches``); ``dia_stencil_t``
and ``bsr_spmm`` their forward and backward launches in phase 20 (``grad_launches``), and
``bsr_spmm`` its complex64 numbers at phase 21's cell under ``c64_`` keys, with ``c64_launches`` its
launches in phase 21's estimator calls; every kernel its launches through the sharded operators in
phase 23 (a) (``sharded_launches``) and on both ranks of (b) (``sharded_two_rank_launches``); the
two passes and ``lanczos_dia_advance`` their padded-carry numbers under ``padded_500k_``/``padded_10M_``
keys (the advance kernel's own numbers are its 500k ones, with ``host_ms``/``device_ms`` a launch, its
launches those of phase 23 (a)'s sharded flagship, once a sweep, and ``launches_a_sweep`` its launches on
each sharded sweep of phases 23-24); the four kernels of phase 24 their bf16 numbers under
``bf16_`` keys (pass A's 64 × 10M ones under ``bf16_10M_``), and every kernel its bf16 launches on
phase 24's calls (``bf16_launches``; 0 for pass B and the advance, which have no bf16 instantiation);
the round pair, bfloat16 only, takes its plain keys and its launches from phase 24 (64 × 500k, flat;
the 500k full-bf16 flagship), with B1's and B2's own times (``b1_ms``, ``b2_ms``) and the 10M and padded
numbers under ``bf16_10M_``, ``bf16_padded_500k_`` and ``bf16_padded_10M_``; the two stencils and
``bsr_spmm`` their launches in the forward and backward passes of phase 25 (a)-(b)
(``hermitian_grad_launches``) and their complex backward's error, time, its plain version's autograd's
time and the adjoint build's time from (c) under ``c64_``/``c128_`` keys (``backward_ms``,
``backward_plain_ms``, ``adjoint_build_ms``, ``grad_max_abs_err``); every kernel its launches in phase 26
(``coverage_launches``: the quadrature gradient's forward and backward, the coverage matrix, the edge cases) and in
phase 27 (``contract_launches``); ``cgs_window`` its launches in phase 28 (a) and its numbers from phase 28 (b), the
full window's under plain keys and the partial one's under ``partial_``; the last line is ``{"ok": true, "device": {...}}``.
Without a CUDA device it exits non-zero before printing anything.
"""

import functools
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

DEG, PROBES, ORTH = 20, 64, 0
N_FLAGSHIP, N_LARGE = 500_000, 10_000_000
KERNELS = (
	"dia_stencil_t", "lanczos_dia_step", "lanczos_dia_residual", "lanczos_dia_advance", "lanczos_dia_round", "bsr_spmm", "dia_stencil",
	"cgs_window",
)
# Kernels that only a row-sharded sweep launches (phase 23): the phases of unsharded calls launch them no time.
SHARDED_ONLY = ("lanczos_dia_advance",)
# The standalone finishes (``lanczos_dia_advance``) of each row-sharded sweep of phases 23-24, as counted there:
# one a float32 sweep (its last step's; the others run in the next step's pass A), none a bfloat16 one (B2).
ADVANCE_A_SWEEP = {}
# Kernels that only a bfloat16 sweep launches (phase 24): the float32 phases launch them no time.
BF16_ONLY = ("lanczos_dia_round",)
# Kernels that only a re-orthogonalised sweep launches: phases 16-18 are not asked to launch them (phase 19's
# recipes at orth 5, phase 23's sharded flagship at orth 5 and phase 28 are).
REORTH_ONLY = ("cgs_window",)
SOURCE = {
	"dia_stencil_t": "primate_tpu_torch/csrc/dia_stencil.cu",
	"lanczos_dia_step": "primate_tpu_torch/csrc/dia_stencil.cu",
	"lanczos_dia_residual": "primate_tpu_torch/csrc/dia_stencil.cu",
	"lanczos_dia_advance": "primate_tpu_torch/csrc/dia_stencil.cu",
	"lanczos_dia_round": "primate_tpu_torch/csrc/dia_stencil.cu",
	"bsr_spmm": "primate_tpu_torch/csrc/bsr_spmm.cu",
	"dia_stencil": "primate_tpu_torch/csrc/dia_stencil.cu",
	"cgs_window": "primate_tpu_torch/csrc/cgs_window.cu",
}
REPLACES = {
	"dia_stencil_t": "primate_tpu/ops/dia_pallas.py:152",  # dia_matmat_t_pallas's pallas_call
	# The two passes of the Lanczos step together replace dia_matmat_t_phys's
	# pallas_call and the XLA-fused rest of the step around it.
	"lanczos_dia_step": "primate_tpu/ops/dia_pallas.py:273",
	"lanczos_dia_residual": "primate_tpu/ops/dia_pallas.py:273",
	# The finish of a row-sharded step (the sweep on dia_matmat_t_phys's halo-padded carry).
	"lanczos_dia_advance": "primate_tpu/ops/dia_pallas.py:273",
	# The rest of a bfloat16 step after pass A (the round pair), in place of pass B.
	"lanczos_dia_round": "primate_tpu/ops/dia_pallas.py:273",
	"bsr_spmm": "primate_tpu/ops/spmm_pallas.py:96",  # bsr_matmat_pallas's pallas_call
	"dia_stencil": "primate_tpu/ops/dia_pallas.py:93",  # dia_matmat_pallas's pallas_call
	# The tail of a re-orthogonalised step (v -= αq, the CGS passes, |v|²): _cgs_window's broadcasts, fused by XLA.
	"cgs_window": "primate_tpu/lanczos.py:294",
}
# NVIDIA H100 SXM data sheet: HBM3 at 3.35 TB/s, 67 TFLOP/s float32 outside the
# tensor cores (the kernels run FP32 FMAs on the CUDA cores), 989 TFLOP/s dense
# bfloat16 (the card's peak for bf16 operands, on the tensor cores).
HBM_BYTES_PER_S, FP32_FLOP_PER_S, BF16_FLOP_PER_S = 3.35e12, 67e12, 989e12
# The same sheet: 67 TFLOP/s float64 on the tensor cores (DMMA, exact IEEE float64), the card's peak
# for float64 operands (complex128's operations); 34 outside them.
FP64_FLOP_PER_S = 67e12
# The same sheet: 50 MB of L2. A BSR SpMM's V that fits there is fetched from HBM about once, whatever
# the order of the tiles, so only a larger V has a gathered-traffic bound (``_bsr_traffic``).
L2_BYTES = 50 * 2**20
STENCIL_TOL = {"float32": 1e-5, "float64": 1e-12}  # max-abs error over max|out|
# Phase 7: BASELINE config 3 at audikw_1's scale (943,695 rows, 77.7M nonzeros).
BSR_CELL = dict(n=1_048_576, bs=8, density=3.5e-5, seed=7)
FEM_SIDE = 100  # phase 8: n = side**3
# Phases 9-12: BASELINE configs 2 (CSR graph logdet) and 4 (heat kernel on a mesh).
PL_N, PL_SMALL, MESH_SIDE = 1_000_000, 8192, 1000
TAUS = np.geomspace(0.05, 4.0, 8)
SLQ_CSR = dict(deg=20, orth=5, batch=64, count=64)
TRACE_TOL, DIAG_TOL = 1e-3, 0.1
# Node-major operator applications per call (the JAX programs' matmat count).
BSR_APPLIES = {"hutchpp": 3, "xtrace": 8, "xnystrace": 1, "xdiag": 2}
ALPHA_TOL = {"float32": 1e-4, "float64": 1e-10}  # relative: the summation orders differ
# Phase 13: BASELINE config 5 (the GP log-likelihood) at 10M rows; phase 14: batched CG.
GP = dict(deg=20, orth=0, nv=128, chunk=64, seed=13, solver_rtol=1e-5)
# Relative, each on its own: logdet, yᵀK⁻¹y (no n·log 2π constant) and each θ-gradient component.
GP_TOL, CG_RTOL, CG_RHS = 1e-3, 1e-5, 64
# Phase 15: the Hofstadter model of examples/tight_binding.py at 4,096,000 sites, complex64 (nx a
# multiple of 5, so the Landau gauge of flux 1/5 closes across the periodic x seam).
TB = dict(nx=2000, ny=2048, alpha=0.2)
TB_NV, TB_BETAS = 16, (0.25, 0.5, 1.0, 2.0)
CPLX_TOL = {"complex64": 1e-6, "complex128": 1e-14}  # max-abs error over max|out|
# Phase 16: a 1M path Laplacian in a seeded random order through auto_operator (also phase 17's
# Toeplitz size). Phase 17: eigsh on the mesh (LOBPCG's own stop rule, 10·n·eps·(‖Av‖ + θ), passes
# at its first iteration at n = 1M in float32, so the LOBPCG calls pass tol and cap maxiter);
# filtered_eigsh on the example's grid at 100× its size; block SLQ at two of phase 10's τ.
PREP_PATH_N = 1_000_000
EIG_K, EIG_MAXITER, EIG_TOL = 8, 100, 1e-12
# separated_spectrum: its ends converge within EIG_SEP_MAXITER LOBPCG iterations; eigenvalues within
# EIG_END_TOL·‖A‖ of the closed-form ends, residuals below EIG_RES_TOL·‖A‖.
EIG_SEP_MAXITER, EIG_END_TOL, EIG_RES_TOL = 40, 1e-4, 1e-3
FE_GRID, FE_COUNT = (400, 250), 48
BK_TAUS, BK = (float(TAUS[3]), float(TAUS[6])), dict(b=8, deg=20, nblocks=4)
TOEPLITZ_PROBES = 16
# Phase 18: examples/rectangular_spectra.py's X = L Rᵀ + σ G at m = 2^20, n = 2^17, G a BSR operator
# of 8×8 tiles, about 40M nonzeros. The nuclear norms of the two Gram sides agree within
# NUC_SIGMAS standard deviations of their difference.
RECT = dict(m=1_048_576, n=131_072, bs=8, tiles_per_block_row=5, r=12, sigma=0.05, seed=18)
SVD_K, BIDIAG_DEG, NUC_SIGMAS = 6, 64, 4.0
# Phase 19: the recipes on the operators of phases 4, 9, 10, 17 and 18. REC_N is the flagship size,
# REC_SHIFTS the GP noise sweep, REC_PAIRS the node pairs of the bilinear forms, REC_RHS the
# right-hand sides of tikhonov, REC_BLOCK the personalisations of pagerank, REC_SHIFT the shift
# that leaves 3 eigenvalues of separated_spectrum negative.
REC_N, REC_SEED = N_LARGE, 19
REC_SHIFTS, REC_LAMS, REC_PS = np.geomspace(1e-3, 1.0, 8), (0.1, 1.0, 10.0), (0.5, 1.0, 2.0)
REC_PAIRS, REC_RHS, REC_BLOCK, REC_SHIFT, REC_RTOL = 8, 64, 8, -0.35, 1e-5
# Phase 20: reverse mode through the Lanczos recurrence on phase 10's mesh (float32, 64 probes, deg 20;
# the orth=5 call on 16 probes); the directional derivative against a float64 central difference of
# step GRAD_H along a unit-max direction, within GRAD_DD_TOL (relative), and the float32 gradient
# against the float64 one (computed in two chunks of 32 probes) within GRAD_F64_TOL of its largest
# entry. Then a BSR operator of GRAD_BSR's size (block_random_spd with about 10 tiles a block row, as
# the cell has), 16 probes, deg 12.
GRAD = dict(deg=20, probes=64, orth5_probes=16, seed=20, diag_count=4, diag_batch=16)
GRAD_H, GRAD_DD_TOL, GRAD_F64_TOL = 1e-3, 1e-4, 1e-3
GRAD_BSR = dict(n=131_072, bs=8, density=2.8e-4, seed=20)
# Phase 21: H = A + i·s·(B − Bᵀ) on phase 7's cell (B a seeded real block operator on A's pattern;
# s‖B − Bᵀ‖ stays below A's diagonal dominance, so H is Hermitian positive definite, tr H = tr A).
CBSR_S, CBSR_SEED, CBSR_C128_N = 0.01, 21, 8192
# The complex64 kernel against its plain version at the cell: the real float32 kernel's tolerance
# (max-abs error over max|out|), as each output sums the same 80-odd tile products in another order.
CBSR_TOL = STENCIL_TOL["float32"]
# Phase 25: reverse mode on Hermitian operators. Euler's identity Σ Re(conj(g)·b) = p·estimate is held
# within HG_EULER_TOL of Σ|g|·|b| (the scale of the sum: its terms cancel, tr H = 0 on the Hofstadter cell),
# complex64; the complex backward against the plain version's autograd within HG_GRAD_TOL of its largest
# entry; the complex128 cross-check of the BSR sketches at HG_CROSS's budgets (phase 21's in complex128
# would hold about 90 GB of graph for XNysTrace's 720 columns). Each QR'd block there keeps 64 columns or
# more: at 16-48 columns the calls with a thin QR of 1M rows took 44-97 s each on the card (XNysTrace, which
# has none, 0.1 s; ROADMAP B.6), at 64-240 columns 0.3-1.2 s.
HG_SEED, HG_KPM_M = 25, 3
HG_EULER_TOL = 1e-5  # XNysTrace too: its shift ν ∝ ‖AΩ‖ scales with the operator, so it is of degree 1 as well
HG_GRAD_TOL = {"complex64": STENCIL_TOL["float32"], "complex128": STENCIL_TOL["float64"]}
HG_CROSS = {"hutchpp": dict(m=96), "xtrace": dict(batch=64, converge="count", count=128), "xnystrace": dict(m=96), "xdiag": dict(m=128)}


def _json_default(o):
	"""numpy scalars and arrays in a result (an example's numbers) as Python numbers and lists."""
	if isinstance(o, (np.generic, np.ndarray)):
		return o.tolist()
	raise TypeError(f"{type(o).__name__} is not JSON serializable")


def emit(obj) -> None:
	print(json.dumps(obj, default=_json_default), flush=True)


def build_laplacian(n: int):
	"""The path-graph Laplacian tridiag(-1, 3, -1) of bench.py:73-76."""
	import scipy.sparse as sps

	main = 3.0 * np.ones(n, np.float32)
	off = -1.0 * np.ones(n - 1, np.float32)
	return sps.diags([off, main, off], [-1, 0, 1]).tocsr().astype(np.float32)


def hofstadter_csr(nx: int, ny: int, alpha: float):
	"""The periodic square-lattice Hofstadter Hamiltonian of the tight-binding example: site
	``i = x·ny + y``, x-hops −1, y-hops ``−e^{2πiαx}`` and its conjugate; scipy CSR, complex128
	(``primate_tpu_torch.examples.tight_binding.hofstadter_hamiltonian``)."""
	from primate_tpu_torch.examples.tight_binding import hofstadter_hamiltonian

	return hofstadter_hamiltonian(nx, ny, alpha)


def exact_logdet(n: int) -> float:
	k = np.arange(1, n + 1)
	return float(np.sum(np.log(3.0 - 2.0 * np.cos(k * np.pi / (n + 1)))))


def time_ms(torch, fn, reps: int = 20) -> float:
	"""Mean device time of ``fn`` over ``reps`` launches, by CUDA events, after one warm-up."""
	fn()
	torch.cuda.synchronize()
	start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
	start.record()
	for _ in range(reps):
		fn()
	end.record()
	torch.cuda.synchronize()
	return start.elapsed_time(end) / reps


def launch_times(torch, fn, reps: int = 200) -> dict:
	"""A call's time split into host and device: ``host_ms`` the host clock over a burst of ``reps`` calls with no
	sync (what the host spends to enqueue one), ``device_ms`` the profiler's device time of the kernels a call runs,
	``one_launch_events_ms`` CUDA events around one call after a sync (the median of 20), ``burst_events_ms`` CUDA
	events over the burst (:func:`time_ms`'s way), each per call. Where ``host_ms`` exceeds ``device_ms`` the host
	sets the time of a burst."""
	from torch.autograd import DeviceType
	from torch.profiler import ProfilerActivity, profile

	fn()
	torch.cuda.synchronize()
	t0 = time.perf_counter()
	for _ in range(reps):
		fn()
	host_ms = (time.perf_counter() - t0) * 1e3 / reps
	torch.cuda.synchronize()
	start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
	one = []
	for _ in range(20):
		torch.cuda.synchronize()
		start.record()
		fn()
		end.record()
		torch.cuda.synchronize()
		one.append(start.elapsed_time(end))
	start.record()
	for _ in range(reps):
		fn()
	end.record()
	torch.cuda.synchronize()
	burst = start.elapsed_time(end) / reps
	with profile(activities=[ProfilerActivity.CUDA]) as prof:
		for _ in range(reps):
			fn()
		torch.cuda.synchronize()
	dev_ms = lambda e: (getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0.0)) / 1e3  # noqa: E731
	kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and dev_ms(e) > 0]
	return {"host_ms": host_ms, "device_ms": sum(dev_ms(e) for e in kernels) / reps, "one_launch_events_ms": statistics.median(one),
		"burst_events_ms": burst, "device_kernels": {e.key[:60]: e.count / reps for e in kernels}}


def bound(bytes_: float, flops: float, flop_per_s: float = FP32_FLOP_PER_S) -> tuple:
	"""The least time the card could take (ms) and what sets it: ``flops`` at the card's peak rate
	for the operands' type (float32 unless given)."""
	t_bytes, t_flops = bytes_ / HBM_BYTES_PER_S * 1e3, flops / flop_per_s * 1e3
	return (t_bytes, "bytes") if t_bytes >= t_flops else (t_flops, "operations")


def library_ms(torch, fn, want, reps: int = 10):
	"""Time of one PyTorch call that computes the same function (a yardstick the
	port never calls), and its error against the plain version; (None, reason) if
	PyTorch refuses the call."""
	try:
		got = fn()
		torch.cuda.synchronize()
	except (RuntimeError, NotImplementedError, TypeError) as e:
		return None, f"{type(e).__name__}: {e}"[:300]
	err = float((got.to_dense() if got.layout != torch.strided else got).sub(want).abs().max()) / float(want.abs().max())
	return time_ms(torch, fn, reps), err


def csr_of_dia(torch, bands, offsets, n: int):
	"""The DIA operator as a CSR tensor on the card (the library yardstick's operand)."""
	r = torch.arange(n, device=bands.device)
	rows, cols, vals = [], [], []
	for d, off in enumerate(offsets):
		c = r + off
		ok = (c >= 0) & (c < n)
		rows.append(r[ok])
		cols.append(c[ok])
		vals.append(bands[d][ok])
	idx = torch.stack([torch.cat(rows), torch.cat(cols)])
	return torch.sparse_coo_tensor(idx, torch.cat(vals), (n, n)).coalesce().to_sparse_csr()


def check_kernels(torch, dia, dev) -> dict:
	"""Phase 2: each DIA kernel and the two step passes against their plain versions
	on the same inputs on the card; times at the flagship shape in float32, and the probe-major stencil's
	in float64 too (``f64_`` keys)."""
	from primate_tpu_torch.ops import _common
	from primate_tpu_torch.ops._build import load_library

	lib = load_library()
	shapes = {"flagship": (PROBES, N_FLAGSHIP, (-1, 0, 1)), "awkward": (13, 3001, (-200, -7, 0, 7, 200))}
	gen = torch.Generator(device=dev)
	gen.manual_seed(0)
	out = {}
	for label, (nv, n, offsets) in shapes.items():
		for dtype in (torch.float32, torch.float64):
			name = str(dtype).removeprefix("torch.")
			bands = torch.rand((len(offsets), n), generator=gen, device=dev, dtype=dtype) + 0.5
			offs = torch.tensor(offsets, dtype=torch.int64, device=dev)
			offs_host = offs.cpu()  # the plain versions read the offsets on the host: no sync per call
			apply_ref = lambda q: dia.dia_stencil_t_ref(bands, offs_host, q)  # noqa: E731
			x = torch.randn((nv, n), generator=gen, device=dev, dtype=dtype)
			q_cur = torch.randn((nv, n), generator=gen, device=dev, dtype=dtype)
			q_cur /= torch.linalg.vector_norm(q_cur, dim=1, keepdim=True)
			q_prev = torch.randn((nv, n), generator=gen, device=dev, dtype=dtype)
			q_prev /= torch.linalg.vector_norm(q_prev, dim=1, keepdim=True)
			beta = torch.rand(nv, generator=gen, device=dev, dtype=dtype) + 0.5

			def mid_sweep_state():
				st = dia.lanczos_state(nv, dtype, dev)
				st.scal[dia.DIV_CUR] = 2.0
				st.scal[dia.DIV_PREV] = 0.5
				st.scal[dia.BETA] = beta
				return st

			got, want = dia.dia_stencil_t(bands, offs, x), dia.dia_stencil_t_ref(bands, offs_host, x)
			v, alpha = dia.lanczos_dia_step(bands, offs, q_cur, q_prev, beta)
			v_ref, alpha_ref = dia.lanczos_dia_step_ref(bands, offs_host, q_cur, q_prev, beta)
			# Two whole steps from the same mid-sweep state, kernels against the plain version.
			st, st_ref = mid_sweep_state(), mid_sweep_state()
			blocks, blocks_ref = (q_cur, q_prev), (q_cur, q_prev)
			errs_w, errs_ab = [], []
			for _ in range(2):
				ab, ab_ref = torch.empty((2, nv), dtype=dtype, device=dev), torch.empty((2, nv), dtype=dtype, device=dev)
				w = dia.lanczos_dia_sweep_step(bands, offs, *blocks, st, ab[0], ab[1], 1e-8)
				w_ref = dia.lanczos_sweep_step_ref(apply_ref, *blocks_ref, st_ref, ab_ref[0], ab_ref[1], 1e-8)
				blocks, blocks_ref = (w, blocks[0]), (w_ref, blocks_ref[0])
				errs_w.append((float((w - w_ref).abs().max()), float((w - w_ref).abs().max()) / float(w_ref.abs().max())))
				errs_ab.append(float(((ab - ab_ref).abs() / ab_ref.abs()).max()))
			torch.cuda.synchronize()
			err_s = float((got - want).abs().max())
			err_v = float((v - v_ref).abs().max())
			err_a = float((alpha - alpha_ref).abs().max())
			rel_s = err_s / float(want.abs().max())
			rel_v = err_v / float(v_ref.abs().max())
			rel_a = float(((alpha - alpha_ref).abs() / alpha_ref.abs()).max())
			rel_w, rel_ab = max(e[1] for e in errs_w), max(errs_ab)
			row = {"phase": "kernel_check", "shape": label, "nv": nv, "n": n, "offsets": list(offsets), "dtype": name,
				"stencil_max_abs_err": err_s, "stencil_rel_err": rel_s, "pass_a_v_max_abs_err": err_v,
				"pass_a_v_rel_err": rel_v, "alpha_max_abs_err": err_a, "alpha_rel_err": rel_a,
				"whole_step_v_rel_err": rel_w, "whole_step_alpha_beta_rel_err": rel_ab}
			if label == "flagship" and dtype == torch.float32:
				item, n_d = 4, len(offsets)
				X_t = x.T
				A_csr = csr_of_dia(torch, bands, offsets, n)
				st, st_ref = mid_sweep_state(), mid_sweep_state()
				ab = torch.empty((2, nv), dtype=dtype, device=dev)
				w_a, partial, gx, vec = dia._launch_pass_a(lib, bands, offs, q_cur, q_prev, st.scal, st.ticket, ab[0])
				w_b_ref = w_a.clone()
				timed = {
					"dia_stencil_t": (lambda: dia.dia_stencil_t(bands, offs, x), lambda: dia.dia_stencil_t_ref(bands, offs_host, x),
						(2 * nv * n + n_d * n) * item, 2 * n_d * nv * n),
					"lanczos_dia_step": (
						lambda: dia._launch_pass_a(lib, bands, offs, q_cur, q_prev, st.scal, st.ticket, ab[0]),
						lambda: dia.lanczos_sweep_pass_a_ref(apply_ref, q_cur, q_prev, st_ref, ab[0]),
						(3 * nv * n + n_d * n) * item, (2 * n_d + 4) * nv * n),
					"lanczos_dia_residual": (
						lambda: dia._launch_pass_b(lib, q_cur, w_a, st, partial, ab[1], 1e-8, gx, vec),
						lambda: dia.lanczos_sweep_pass_b_ref(q_cur, w_b_ref, st_ref, ab[1], 1e-8),
						3 * nv * n * item, 4 * nv * n),
					"whole_step": (
						lambda: dia.lanczos_dia_sweep_step(bands, offs, q_cur, q_prev, st, ab[0], ab[1], 1e-8),
						lambda: dia.lanczos_sweep_step_ref(apply_ref, q_cur, q_prev, st_ref, ab[0], ab[1], 1e-8),
						(6 * nv * n + n_d * n) * item, (2 * n_d + 8) * nv * n),
				}
				errs = {"dia_stencil_t": err_s, "lanczos_dia_step": max(err_v, errs_w[0][0]),
					"lanczos_dia_residual": max(e[0] for e in errs_w), "whole_step": max(e[0] for e in errs_w)}
				for k, (kern, plain, bytes_, flops) in timed.items():
					ms, plain_ms = _timed_pair(torch, kern, plain, 20)
					b_ms, b_by = bound(bytes_, flops)
					lib_ms, lib_note = (None, "no single PyTorch call computes a Lanczos step")
					if k == "dia_stencil_t":  # the same numbers in the transposed layout: out.T = A X.T
						lib_ms, lib_note = library_ms(torch, lambda: A_csr @ X_t, want.T)
					row.update({f"{k}_ms": ms, f"{k}_plain_ms": plain_ms, f"{k}_bound_ms": b_ms, f"{k}_bound_by": b_by,
						f"{k}_GBps": bytes_ / ms / 1e6, f"{k}_library_ms": lib_ms, f"{k}_library_note": lib_note})
					out[k] = {"max_abs_err": errs[k], "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
						"library_ms": lib_ms}
				row["scalar_launches"] = dict(_common.SCALAR_LAUNCHES)
				del A_csr
			if label == "flagship" and dtype == torch.float64:  # the probe-major stencil in float64 at the same shape
				bytes_, flops = (2 * nv * n + len(offsets) * n) * 8, 2 * len(offsets) * nv * n
				ms, plain_ms = _timed_pair(torch, lambda: dia.dia_stencil_t(bands, offs, x), lambda: dia.dia_stencil_t_ref(bands, offs_host, x), 20)
				b_ms, b_by = bound(bytes_, flops, FP64_FLOP_PER_S)
				A_csr, X_t = csr_of_dia(torch, bands, offsets, n), x.T
				lib_ms, lib_note = library_ms(torch, lambda: A_csr @ X_t, want.T)
				del A_csr
				row.update({"dia_stencil_t_ms": ms, "dia_stencil_t_plain_ms": plain_ms, "dia_stencil_t_bound_ms": b_ms,
					"dia_stencil_t_bound_by": b_by, "dia_stencil_t_library_ms": lib_ms, "dia_stencil_t_library_note": lib_note})
				out.setdefault("dia_stencil_t", {}).update({"f64_max_abs_err": err_s, "f64_ms": ms, "f64_plain_ms": plain_ms,
					"f64_bound_ms": b_ms, "f64_bound_by": b_by, "f64_library_ms": lib_ms})
			emit(row)
			if not (rel_s <= STENCIL_TOL[name] and rel_v <= STENCIL_TOL[name] and rel_a <= ALPHA_TOL[name]
				and rel_w <= STENCIL_TOL[name] and rel_ab <= ALPHA_TOL[name]):
				raise AssertionError(f"kernel disagrees with its plain version: {row}")
	return out


def check_padded_kernels(torch, dia, dev) -> dict:
	"""Phase 2 on the padded carry (``DIAOperator.carry_spec``: the layout of ``lanczos_block_op(phys=True)``
	and of the row-sharded sweep) at the flagship's 64 × 500k and 64 × 10M, float32: two whole steps in
	the row-sharded mode (an identity all-reduce; pass A and pass B a step, each step's finish left pending
	for the next step's pass A and the last one run by ``lanczos_dia_finish``, the advance kernel) against the
	eager plain step, the margins exactly zero, and each kernel timed in that mode beside its plain version
	and bound: pass A also with a pending finish (``folded_ms``, in turns with pass A without one), the advance
	kernel also split into host and device time (:func:`launch_times`). Returns ``{kernel: {"padded_<shape>_ms",
	...}}`` and the advance kernel's own entry."""
	from primate_tpu_torch.ops import _common
	from primate_tpu_torch.ops._build import load_library

	lib = load_library()
	offsets, item, dtype = (-1, 0, 1), 4, torch.float32
	n_d = len(offsets)
	gen = torch.Generator(device=dev)
	gen.manual_seed(2)
	out = {}
	for label, n, reps in (("500k", N_FLAGSHIP, 20), ("10M", N_LARGE, 5)):
		nv = PROBES
		spec = dia.carry_spec(n, max(abs(o) for o in offsets), item)
		bands = spec.pad(torch.rand((n_d, n), generator=gen, device=dev, dtype=dtype) + 0.5)
		offs = torch.tensor(offsets, dtype=torch.int64, device=dev)
		offs_host = offs.cpu()
		apply_ref = lambda q: dia.dia_stencil_t_ref(bands, offs_host, q)  # noqa: E731

		def unit_carry():
			X = torch.randn((nv, n), generator=gen, device=dev, dtype=dtype)
			return spec.pad(X / torch.linalg.vector_norm(X, dim=1, keepdim=True))

		v_cur, v_prev = unit_carry(), unit_carry()
		beta = torch.rand(nv, generator=gen, device=dev, dtype=dtype) + 0.5

		def mid_sweep_state():
			st = dia.lanczos_state(nv, dtype, dev)
			st.scal[dia.DIV_CUR] = 2.0
			st.scal[dia.DIV_PREV] = 0.5
			st.scal[dia.BETA] = beta
			return st

		st, st_ref = mid_sweep_state(), mid_sweep_state()
		blocks, blocks_ref = (v_cur, v_prev), (v_cur, v_prev)
		errs_w, margins = [], 0.0
		scalar_before, launch_before = dict(_common.SCALAR_LAUNCHES), dict(dia.LAUNCHES)
		ab, ab_ref = torch.empty((2, 2, nv), dtype=dtype, device=dev), torch.empty((2, 2, nv), dtype=dtype, device=dev)
		for j in range(2):
			w = dia.lanczos_dia_sweep_step(bands, offs, *blocks, st, ab[j, 0], ab[j, 1], 1e-8, spec, lambda t: t)
			w_ref = dia.lanczos_sweep_step_ref(apply_ref, *blocks_ref, st_ref, ab_ref[j, 0], ab_ref[j, 1], 1e-8, spec=spec)
			blocks, blocks_ref = (w, blocks[0]), (w_ref, blocks_ref[0])
			errs_w.append(_rel_err(torch, w, w_ref))
			margins = max(margins, float(w[:, : spec.lo].abs().max()), float(w[:, spec.lo + n :].abs().max()))
		dia.lanczos_dia_finish(st)  # the second step's finish (the first one's ran in the second step's pass A)
		torch.cuda.synchronize()
		sweep_launches = {k: dia.LAUNCHES[k] - launch_before[k] for k in ("lanczos_dia_step", "lanczos_dia_residual", "lanczos_dia_advance")}
		errs_ab = [float(((ab - ab_ref).abs() / ab_ref.abs()).max())]
		rows_ = [dia.DIV_CUR, dia.DIV_PREV, dia.BETA, dia.ALPHA]
		errs_ab.append(float(((st.scal[rows_] - st_ref.scal[rows_]).abs() / st_ref.scal[rows_].abs()).max()))
		done_same = torch.equal(st.scal[dia.DONE], st_ref.scal[dia.DONE])
		scalar = {k: _common.SCALAR_LAUNCHES[k] - scalar_before[k] for k in ("lanczos_dia_step", "lanczos_dia_residual")}
		rel_w, rel_ab = max(e[1] for e in errs_w), max(errs_ab)
		# The advance kernel alone against its plain version, from the same sums and state.
		sums = torch.rand((2, nv), generator=gen, device=dev, dtype=dtype) + 0.5
		st_a, st_b = mid_sweep_state(), mid_sweep_state()
		st_a.scal[dia.DONE, 0] = st_b.scal[dia.DONE, 0] = 1.0
		ab_a, ab_b = torch.empty((2, nv), dtype=dtype, device=dev), torch.empty((2, nv), dtype=dtype, device=dev)
		dia._launch_advance(lib, sums, st_a, ab_a[0], ab_a[1], 1e-8)
		dia.lanczos_dia_advance_ref(sums, st_b, ab_b[0], ab_b[1], 1e-8)
		torch.cuda.synchronize()
		err_adv = max(float((st_a.scal - st_b.scal).abs().max()), float((ab_a - ab_b).abs().max()))
		# Pass A with a pending finish (the step before's, from seeded sums) against the advance kernel, then pass A.
		fin_a = dia.Finish(sums.clone(), torch.empty(nv, dtype=dtype, device=dev), torch.empty(nv, dtype=dtype, device=dev), 1e-8)
		fin_b = dia.Finish(sums.clone(), torch.empty(nv, dtype=dtype, device=dev), torch.empty(nv, dtype=dtype, device=dev), 1e-8)
		st_a, st_b = mid_sweep_state(), mid_sweep_state()
		s_a, s_b = torch.empty(nv, dtype=dtype, device=dev), torch.empty(nv, dtype=dtype, device=dev)
		w_fa = dia._launch_pass_a(lib, bands, offs, v_cur, v_prev, st_a.scal, st_a.ticket, None, spec, s_a, pending=fin_a)[0]
		dia._launch_advance(lib, fin_b.sums, st_b, fin_b.alpha_out, fin_b.beta_out, 1e-8)
		w_fb = dia._launch_pass_a(lib, bands, offs, v_cur, v_prev, st_b.scal, st_b.ticket, None, spec, s_b)[0]
		torch.cuda.synchronize()
		folded_bits = (torch.equal(w_fa, w_fb) and torch.equal(s_a, s_b) and torch.equal(st_a.scal, st_b.scal)
			and torch.equal(fin_a.alpha_out, fin_b.alpha_out) and torch.equal(fin_a.beta_out, fin_b.beta_out))
		del w_fa, w_fb
		row = {"phase": "padded_kernel_check", "shape": label, "nv": nv, "n": n, "ld": spec.ld, "lo": spec.lo,
			"offsets": list(offsets), "dtype": "float32", "whole_step_v_rel_err": rel_w, "whole_step_alpha_beta_rel_err": rel_ab,
			"done_flags_equal": done_same, "margin_max_abs": margins, "scalar_launches": scalar, "sweep_launches": sweep_launches,
			"advance_max_abs_err": err_adv, "folded_pass_a_equals_advance_then_pass_a": folded_bits}
		# Timed in the row-sharded mode, as the sharded sweep runs them.
		st, st_ref = mid_sweep_state(), mid_sweep_state()
		ab = torch.empty((2, nv), dtype=dtype, device=dev)
		w_a, partial, gx, vec = dia._launch_pass_a(lib, bands, offs, v_cur, v_prev, st.scal, st.ticket, None, spec, sums[0])
		w_b_ref = w_a.clone()
		timed = {
			"lanczos_dia_step": (
				lambda: dia._launch_pass_a(lib, bands, offs, v_cur, v_prev, st.scal, st.ticket, None, spec, sums[0]),
				lambda: dia.lanczos_sweep_pass_a_ref(apply_ref, v_cur, v_prev, st_ref, ab[0], spec=spec),
				(3 * nv * n + n_d * n) * item, (2 * n_d + 4) * nv * n),
			"lanczos_dia_residual": (
				lambda: dia._launch_pass_b(lib, v_cur, w_a, st, partial, ab[1], 1e-8, gx, vec, spec, sums),
				lambda: dia.lanczos_sweep_pass_b_ref(v_cur, w_b_ref, st_ref, ab[1], 1e-8, spec=spec),
				3 * nv * n * item, 4 * nv * n),
			"lanczos_dia_advance": (
				lambda: dia._launch_advance(lib, sums, st, ab[0], ab[1], 1e-8),
				lambda: dia.lanczos_dia_advance_ref(sums, st_ref, ab[0], ab[1], 1e-8),
				11 * nv * item, 6 * nv),
		}
		errs = {"lanczos_dia_step": max(e[0] for e in errs_w), "lanczos_dia_residual": max(e[0] for e in errs_w),
			"lanczos_dia_advance": err_adv}
		for k, (kern, plain, bytes_, flops) in timed.items():
			ms, plain_ms = _timed_pair(torch, kern, plain, reps)
			b_ms, b_by = bound(bytes_, flops)
			row.update({f"{k}_ms": ms, f"{k}_plain_ms": plain_ms, f"{k}_bound_ms": b_ms, f"{k}_bound_by": b_by,
				f"{k}_GBps": bytes_ / ms / 1e6})
			entry = out.setdefault(k, {})
			entry.update({f"padded_{label}_ms": ms, f"padded_{label}_plain_ms": plain_ms, f"padded_{label}_bound_ms": b_ms,
				f"padded_{label}_max_abs_err": errs[k]})
			if k == "lanczos_dia_advance" and label == "500k":  # its entry in the kernels line: nv = 64
				split = launch_times(torch, kern)
				entry.update({"max_abs_err": err_adv, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
					"library_ms": None, "host_ms": split["host_ms"], "device_ms": split["device_ms"],
					"one_launch_events_ms": split["one_launch_events_ms"]})
				row.update({"advance_host_ms": split["host_ms"], "advance_device_ms": split["device_ms"]})
		# Pass A with the step before's finish pending, in turns with pass A without one (the row-sharded mode), on a
		# state of their own: the finish's sums stay as seeded, so every launch finds the same positive divisors.
		fin = dia.Finish(torch.rand((2, nv), generator=gen, device=dev, dtype=dtype) + 0.5, ab[0].clone(), ab[1].clone(), 1e-8)
		st_f, s_out = mid_sweep_state(), torch.empty((2, nv), dtype=dtype, device=dev)
		no_fin, with_fin = (
			lambda: dia._launch_pass_a(lib, bands, offs, v_cur, v_prev, st_f.scal, st_f.ticket, None, spec, s_out[0]),
			lambda: dia._launch_pass_a(lib, bands, offs, v_cur, v_prev, st_f.scal, st_f.ticket, None, spec, s_out[1], pending=fin),
		)
		t_no, t_with = _timed_pair(torch, no_fin, with_fin, reps)
		row.update({"lanczos_dia_step_folded_ms": t_with, "lanczos_dia_step_unfolded_ms": t_no})
		out["lanczos_dia_step"].update({f"padded_{label}_folded_ms": t_with, f"padded_{label}_unfolded_ms": t_no})
		emit(row)
		want_launches = {"lanczos_dia_step": 2, "lanczos_dia_residual": 2, "lanczos_dia_advance": 1}
		if not (rel_w <= STENCIL_TOL["float32"] and rel_ab <= ALPHA_TOL["float32"] and done_same and margins == 0.0 and err_adv <= 1e-6
			and not any(scalar.values()) and folded_bits and sweep_launches == want_launches):
			raise AssertionError(f"the step kernels on the padded carry disagree with their plain versions: {row}")
		del bands, v_cur, v_prev, blocks, blocks_ref, w, w_ref, w_a, w_b_ref, partial
		torch.cuda.empty_cache()
	return out


def flagship(torch, ptt, dia, dev, n: int, reps: int) -> dict:
	"""Phases 3 and 4: bench.py's SLQ logdet through the port, float32."""
	L = build_laplacian(n)
	op = ptt.DIAOperator.from_scipy(L, dtype=torch.float32, device=dev)
	M = ptt.MatrixFunction(op, fun="log", deg=DEG, orth=ORTH, reorth_passes=1, dtype=torch.float32)

	def run():
		est = ptt.hutch(M, batch=PROBES, converge="count", count=PROBES, seed=42)
		torch.cuda.synchronize()
		return est

	torch.cuda.reset_peak_memory_stats()
	dia.reset_launches()
	est = run()  # the counted run of the main path; also the warm-up
	launches = dict(dia.LAUNCHES)
	times = []
	for _ in range(reps):
		t0 = time.perf_counter()
		run()
		times.append(time.perf_counter() - t0)
	exact = exact_logdet(n)
	rel = abs(est - exact) / abs(exact)
	row = {"phase": "flagship", "n": n, "deg": DEG, "probes": PROBES, "dtype": "float32", "estimate": est,
		"exact": exact, "rel_err": rel, "wall_s_median": statistics.median(times), "wall_s": times,
		"max_memory_allocated_bytes": torch.cuda.max_memory_allocated(), "launches": launches}
	emit(row)
	batches = -(-PROBES // PROBES)  # count / batch
	if not rel < 0.05:
		raise AssertionError(f"logdet rel err {rel} at n={n}")
	for k in ("lanczos_dia_step", "lanczos_dia_residual"):
		if launches[k] != DEG * batches:
			raise AssertionError(f"step kernel {k} launched {launches[k]} times, expected {DEG * batches}")
	return row


def plain_trace(torch, ptt, dia, dev) -> dict:
	"""Phase 5: tr(L) = 3n by Girard-Hutchinson on the DIA operator itself (stencil kernel)."""
	n = N_FLAGSHIP
	op = ptt.DIAOperator.from_scipy(build_laplacian(n), dtype=torch.float32, device=dev)
	dia.reset_launches()
	est, res = ptt.hutch(op, batch=PROBES, converge="count", count=PROBES, seed=7, full=True)
	launches = dict(dia.LAUNCHES)
	sigma = float(np.sqrt(res.estimator.converged_variance / res.nit))
	row = {"phase": "plain_trace", "n": n, "estimate": est, "exact": 3.0 * n, "sigma": sigma, "launches": launches}
	emit(row)
	if not abs(est - 3.0 * n) <= 5 * sigma:
		raise AssertionError(f"trace estimate {est} more than 5 sigma ({sigma}) from {3.0 * n}")
	if launches["dia_stencil_t"] < 1:
		raise AssertionError("the plain trace did not launch the stencil kernel")
	return row


def _rel_err(torch, got, want) -> tuple:
	err = float((got - want).abs().max())
	return err, err / max(float(want.abs().max()), 1e-300)


def _bytes_bsr(op, k: int, item: int) -> int:
	"""Least traffic of one BSR SpMM: the tiles, V once and the output once."""
	return (op.nnz + op.shape[1] * k + op.shape[0] * k) * item


def _gathered_bytes_bsr(op, k: int, item: int) -> int:
	"""Traffic of a BSR SpMM that gathers V afresh for every tile: the tiles, bn rows of V per tile, the output."""
	nnzb, _, bn = op.blocks.shape
	return (op.nnz + nnzb * bn * k + op.shape[0] * k) * item


def _bsr_traffic(op, k: int, item: int, ms: float, bound_ms: float, dtype: str) -> dict:
	"""Emits the BSR SpMM's time against its byte counts: the least (V read once; its bound is the kernel's
	``bound_ms``) and, where V is larger than the L2, the gathered: ``bn`` rows of V fetched from HBM for
	every tile, as the kernel's order of tiles (block row by block row) reads a random block structure.
	That is the bound of this traversal, not of the function. Returns the gathered bound and share, or
	nothing where V fits in L2."""
	v_bytes = op.shape[1] * k * item
	row = {"phase": "bsr_traffic", "dtype": dtype, "k": k, "ms": ms, "least_bytes": _bytes_bsr(op, k, item),
		"least_share_of_bound": bound_ms / ms, "v_bytes": v_bytes, "l2_bytes": L2_BYTES}
	g = {}
	if v_bytes > L2_BYTES:
		gathered = _gathered_bytes_bsr(op, k, item)
		g = {"gathered_bound_ms": gathered / HBM_BYTES_PER_S * 1e3, "gathered_share_of_bound": gathered / HBM_BYTES_PER_S * 1e3 / ms}
		row.update({"gathered_bytes": gathered, "gathered_GBps": gathered / ms / 1e6, **g})
	emit(row)
	return g


def _timed_turns(torch, fns, reps: int) -> list:
	"""Each of ``fns`` by CUDA events, in turns (in order, then back): the mean of its two times each."""
	t = [time_ms(torch, f, reps) for f in (*fns, *reversed(fns))]
	return [(t[i] + t[-1 - i]) / 2 for i in range(len(fns))]


def _timed_pair(torch, kern, plain, reps: int) -> tuple:
	"""Kernel and plain version by CUDA events, in the order plain, kernel, kernel, plain."""
	plain_ms, ms = _timed_turns(torch, (plain, kern), reps)
	return ms, plain_ms


def check_sparse_kernels(torch, ptt, bsr_op, dia_op, dev, cell_ks=(64, 240), reps: int = 10) -> dict:
	"""Phase 6: the BSR SpMM and the node-major DIA stencil against their plain
	versions at the cell operators and at awkward shapes, float32 and float64;
	float32 cell shapes timed beside their bound and their library call. Also the
	probe-major stencil at the shape the FEM cell's ``diag`` gives it (64 × n, 7
	diagonals), timed the same way, its numbers going to the ``kernels`` line beside
	the flagship-shape ones under ``fem_`` keys, and at awkward probe-major shapes."""
	import scipy.sparse as sps
	from primate_tpu_torch.ops import _common, bsr, dia

	gen = torch.Generator(device=dev)
	gen.manual_seed(1)
	out = {}

	def run(label, name, kern, plain, dtype, k, timed=None, route=None, library=None, prefix=""):
		"""``timed``: (bytes, flops) of the call, for the float32 cell shapes; its numbers at the
		first cell k go to the kernel's entry of the ``kernels`` line, under keys that start with ``prefix``."""
		tname = str(dtype).removeprefix("torch.")
		got, want = kern(), plain()
		torch.cuda.synchronize()
		err, rel = _rel_err(torch, got, want)
		row = {"phase": "sparse_kernel_check", "kernel": name, "shape": label, "k": k, "dtype": tname,
			"max_abs_err": err, "rel_err": rel, "tol": STENCIL_TOL[tname]}
		if timed is not None:
			bytes_, flops = timed
			ms, plain_ms = _timed_pair(torch, kern, plain, reps)
			b_ms, b_by = bound(bytes_, flops)
			lib_ms, lib_note = library_ms(torch, library, want, reps)
			row.update({"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "GBps": bytes_ / ms / 1e6,
				"library_ms": lib_ms, "library_rel_err_or_error": lib_note})
			if route is not None:
				row["transpose_route_ms"] = time_ms(torch, route, reps)
			if k == cell_ks[0]:
				out.setdefault(name, {}).update({f"{prefix}{key}": v for key, v in (("max_abs_err", err), ("ms", ms),
					("plain_ms", plain_ms), ("bound_ms", b_ms), ("bound_by", b_by), ("library_ms", lib_ms))})
		emit(row)
		if not rel <= STENCIL_TOL[tname]:
			raise AssertionError(f"{name} disagrees with its plain version: {row}")
		return row

	A_csr = csr_of_dia(torch, dia_op.bands, dia_op.offsets, dia_op.shape[0])
	for dtype in (torch.float32, torch.float64):
		B = ptt.BSROperator(bsr_op.blocks.to(dtype), bsr_op.indices, bsr_op.indptr, bsr_op.shape)
		D = ptt.DIAOperator(dia_op.bands.to(dtype), dia_op.offsets, dia_op.shape)
		offs_host = D.offsets_t.cpu()
		f32 = dtype == torch.float32
		if f32:  # the library yardsticks, built once: cuSPARSE BSR and CSR operands
			B_lib = torch.sparse_bsr_tensor(B.indptr, B.indices, B.blocks, size=B.pshape)
		for k in cell_ks:
			item = 4 if f32 else 8
			V = torch.randn((B.shape[0], k), generator=gen, device=dev, dtype=dtype)
			args = (B.blocks, B.indptr, B.indices, V, B.shape[0])
			nnzb, bm, bn = B.blocks.shape
			row = run("bsr_cell", "bsr_spmm", lambda: bsr.bsr_spmm(*args), lambda: bsr.bsr_spmm_ref(*args), dtype, k,
				timed=(_bytes_bsr(B, k, item), 2 * nnzb * bm * bn * k) if f32 else None,
				library=(lambda: B_lib @ V) if f32 else None)
			if f32:
				g = _bsr_traffic(B, k, item, row["ms"], row["bound_ms"], "float32")
				if k == cell_ks[0]:
					out["bsr_spmm"].update(g)
			del V
			V = torch.randn((D.shape[0], k), generator=gen, device=dev, dtype=dtype)
			run("fem_cell", "dia_stencil", lambda: dia.dia_stencil(D.bands, D.offsets_t, V),
				lambda: dia.dia_stencil_ref(D.bands, offs_host, V), dtype, k,
				timed=((2 * D.shape[0] * k + D.nnz) * item, 2 * D.nnz * k) if f32 else None,
				route=lambda: dia.dia_stencil_t(D.bands, D.offsets_t, V.T.contiguous()).T, library=lambda: A_csr @ V)
			del V
			if k == cell_ks[0]:  # diag's probe block on the FEM cell, probe-major
				Xt = torch.randn((k, D.shape[0]), generator=gen, device=dev, dtype=dtype)
				run("fem_cell_probe_major", "dia_stencil_t", lambda: dia.dia_stencil_t(D.bands, D.offsets_t, Xt),
					lambda: dia.dia_stencil_t_ref(D.bands, offs_host, Xt), dtype, k,
					timed=((2 * D.shape[0] * k + D.nnz) * item, 2 * D.nnz * k) if f32 else None,
					library=lambda: (A_csr @ Xt.T).T, prefix="fem_")
				del Xt
		if f32:
			del B_lib
		# Awkward shapes: non-square tiles, 4x4, an empty block row, n not a multiple of bm.
		rng = np.random.default_rng(2)
		for bm, bn in ((8, 16), (4, 4), (8, 8)):
			n = 1001
			A = sps.random(n, n, density=0.01, random_state=rng, format="csr")
			A = sps.csr_matrix(A.toarray() * (np.arange(n) // bm != 3)[:, None])  # block row 3 left empty
			pad = (-(-n // bm) * bm, -(-n // bn) * bn)
			A.resize(pad)
			S = A.tobsr(blocksize=(bm, bn))
			assert np.diff(S.indptr)[3] == 0
			blocks = torch.tensor(S.data, dtype=dtype, device=dev)
			indptr = torch.tensor(S.indptr, dtype=torch.int64, device=dev)
			indices = torch.tensor(S.indices, dtype=torch.int64, device=dev)
			for k in (1, 65, 130, 720):
				V = torch.randn((n, k), generator=gen, device=dev, dtype=dtype)
				args = (blocks, indptr, indices, V, n)
				run(f"bsr_{bm}x{bn}_n{n}", "bsr_spmm", lambda: bsr.bsr_spmm(*args), lambda: bsr.bsr_spmm_ref(*args), dtype, k)
		n, offsets = 12_000, (-10_000, -7, 0, 3, 10_000)
		bands = torch.rand((len(offsets), n), generator=gen, device=dev, dtype=dtype) + 0.5
		offs = torch.tensor(offsets, dtype=torch.int64, device=dev)
		for k in (1, 130, 720):
			V = torch.randn((n, k), generator=gen, device=dev, dtype=dtype)
			run("dia_offsets_pm10000", "dia_stencil", lambda: dia.dia_stencil(bands, offs, V),
				lambda: dia.dia_stencil_ref(bands, offs.cpu(), V), dtype, k)
		# The probe-major stencil at the same offsets (k: the probe count nv), and on a block
		# one element past a 16-byte boundary, which takes its scalar path.
		for nv in (1, 13, 64):
			X = torch.randn((nv, n), generator=gen, device=dev, dtype=dtype)
			run("dia_t_offsets_pm10000", "dia_stencil_t", lambda: dia.dia_stencil_t(bands, offs, X),
				lambda: dia.dia_stencil_t_ref(bands, offs.cpu(), X), dtype, nv)
		X = torch.randn(13 * n + 1, generator=gen, device=dev, dtype=dtype)[1:].view(13, n)
		scalar = _common.SCALAR_LAUNCHES["dia_stencil_t"]
		run("dia_t_offsets_pm10000_misaligned", "dia_stencil_t", lambda: dia.dia_stencil_t(bands, offs, X),
			lambda: dia.dia_stencil_t_ref(bands, offs.cpu(), X), dtype, 13)
		if _common.SCALAR_LAUNCHES["dia_stencil_t"] != scalar + 1:
			raise AssertionError("dia_stencil_t on a misaligned block did not take its scalar path")
	return out


def _grad_err(torch, got, want) -> tuple:
	"""Largest error over the gradients of one call: absolute, and relative to each gradient's largest entry."""
	errs = [_rel_err(torch, g, w) for g, w in zip(got, want)]
	return max(e[0] for e in errs), max(e[1] for e in errs)


def check_backward(torch, ptt, bsr_op, dia_op, dev, reps: int = 5) -> dict:
	"""Phase 6, backward: each kernel Function's input and parameter gradients against
	``torch.autograd.grad`` through its plain version on the card, float32 and float64, at
	the cell shapes (FEM probe-major 64 × 1M, FEM node-major 1M × 64, BSR cell at k = 64),
	on non-symmetric bands (offsets −10,000 … 10,000 at n = 12,000), on a probe block that
	starts one element into its buffer, and on 8×16 tiles over n = 1001 with an empty block
	row; float32 cell backwards timed beside the plain version's autograd."""
	import scipy.sparse as sps
	from primate_tpu_torch.ops import autograd as kad
	from primate_tpu_torch.ops import bsr, dia

	gen = torch.Generator(device=dev)
	gen.manual_seed(6)
	out = {}
	for dtype in (torch.float32, torch.float64):
		tname = str(dtype).removeprefix("torch.")
		rnd = lambda *shape: torch.randn(shape, generator=gen, device=dev, dtype=dtype)  # noqa: E731
		n = dia_op.shape[0]
		bands = dia_op.bands.to(dtype).requires_grad_(True)
		offs, offsets = dia_op.offsets_t, dia_op.offsets
		blocks = bsr_op.blocks.to(dtype).requires_grad_(True)
		ns, offs_ns = 12_000, (-10_000, -7, 0, 3, 10_000)
		bands_ns = (torch.rand((len(offs_ns), ns), generator=gen, device=dev, dtype=dtype) + 0.5).requires_grad_(True)
		offs_ns_t = torch.tensor(offs_ns, dtype=torch.int64, device=dev)
		lead = torch.randn(13 * ns + 1, generator=gen, device=dev, dtype=dtype)
		A = sps.random(1001, 1001, density=0.01, random_state=np.random.default_rng(6), format="csr").toarray()
		A[24:32] = 0.0
		A = sps.csr_matrix(A)
		A.resize((1008, 1008))
		S = A.tobsr(blocksize=(8, 16))
		blocks_s = torch.tensor(S.data, dtype=dtype, device=dev).requires_grad_(True)
		ip_s = torch.tensor(S.indptr, dtype=torch.int64, device=dev)
		ix_s = torch.tensor(S.indices, dtype=torch.int64, device=dev)
		cases = [  # (label, kernel, Function, plain, inputs, cotangent shape, timed)
			("fem_probe_major", "dia_stencil_t", lambda b, x: kad.dia_stencil_t_ad(b, x, offs, offsets),
				lambda b, x: dia.dia_stencil_t_ref(b, offs, x), (bands, rnd(64, n).requires_grad_(True)), (64, n), True),
			("fem_node_major", "dia_stencil", lambda b, v: kad.dia_stencil_ad(b, v, offs, offsets),
				lambda b, v: dia.dia_stencil_ref(b, offs, v), (bands, rnd(n, 64).requires_grad_(True)), (n, 64), True),
			("bsr_cell", "bsr_spmm", lambda b, v: kad.bsr_spmm_ad(b, v, bsr_op.indptr, bsr_op.indices, bsr_op.shape[0]),
				lambda b, v: bsr.bsr_spmm_ref(b, bsr_op.indptr, bsr_op.indices, v, bsr_op.shape[0]),
				(blocks, rnd(bsr_op.shape[0], 64).requires_grad_(True)), (bsr_op.shape[0], 64), True),
			("nonsymmetric_probe_major", "dia_stencil_t", lambda b, x: kad.dia_stencil_t_ad(b, x, offs_ns_t, offs_ns),
				lambda b, x: dia.dia_stencil_t_ref(b, offs_ns_t, x), (bands_ns, rnd(13, ns).requires_grad_(True)), (13, ns), False),
			("nonsymmetric_node_major", "dia_stencil", lambda b, v: kad.dia_stencil_ad(b, v, offs_ns_t, offs_ns),
				lambda b, v: dia.dia_stencil_ref(b, offs_ns_t, v), (bands_ns, rnd(ns, 13).requires_grad_(True)), (ns, 13), False),
			("misaligned_probe_major", "dia_stencil_t", lambda b, x: kad.dia_stencil_t_ad(b, x, offs_ns_t, offs_ns),
				lambda b, x: dia.dia_stencil_t_ref(b, offs_ns_t, x), (bands_ns, lead[1:].view(13, ns).requires_grad_(True)), (13, ns), False),
			("bsr_8x16_n1001", "bsr_spmm", lambda b, v: kad.bsr_spmm_ad(b, v, ip_s, ix_s, 1001),
				lambda b, v: bsr.bsr_spmm_ref(b, ip_s, ix_s, v, 1001), (blocks_s, rnd(1001, 65).requires_grad_(True)), (1001, 65), False),
		]
		for label, name, fn, plain, inputs, g_shape, timed in cases:
			G = rnd(*g_shape)
			y = fn(*inputs)
			if not type(y.grad_fn).__name__.endswith("Backward"):
				raise AssertionError(f"{name}: the apply did not go through its autograd Function")
			got = torch.autograd.grad(y, inputs, G, retain_graph=timed)
			y_ref = plain(*inputs)
			want = torch.autograd.grad(y_ref, inputs, G, retain_graph=timed)
			torch.cuda.synchronize()
			err, rel = _grad_err(torch, got, want)
			row = {"phase": "backward_check", "kernel": name, "shape": label, "dtype": tname, "grad_max_abs_err": err,
				"grad_rel_err": rel, "tol": STENCIL_TOL[tname]}
			del got, want
			if timed and dtype == torch.float32:
				ms, plain_ms = _timed_pair(torch, lambda: torch.autograd.grad(y, inputs, G, retain_graph=True),
					lambda: torch.autograd.grad(y_ref, inputs, G, retain_graph=True), reps)
				row.update({"backward_ms": ms, "backward_plain_ms": plain_ms})
				out.setdefault(name, {}).update({"backward_ms": ms, "backward_plain_ms": plain_ms})
			if timed:
				entry = out.setdefault(name, {})
				entry["grad_max_abs_err"] = max(entry.get("grad_max_abs_err", 0.0), err)
			del y, y_ref
			emit(row)
			if not rel <= STENCIL_TOL[tname]:
				raise AssertionError(f"{name}'s backward disagrees with its plain version's autograd: {row}")
	return out


def _timed_calls(torch, fn, reps: int = 3) -> tuple:
	"""Median host wall time of ``reps`` synchronised calls after one warm-up call (the counted run)."""
	from primate_tpu_torch.ops import _common

	torch.cuda.synchronize()
	torch.cuda.reset_peak_memory_stats()
	_common.reset_launches()
	first = fn()
	torch.cuda.synchronize()
	launches, copies = dict(_common.LAUNCHES), dict(_common.LAYOUT_COPIES)
	times = []
	for _ in range(reps):
		t0 = time.perf_counter()
		fn()
		torch.cuda.synchronize()
		times.append(time.perf_counter() - t0)
	return first, launches, copies, times, torch.cuda.max_memory_allocated()


@functools.lru_cache(maxsize=None)
def _bsr_cell(**cell):
	"""Phase 7's matrix (``block_random_spd``), generated once a run: phase 16 loads it again."""
	from benchmarks.matrices import block_random_spd

	return block_random_spd(**cell)


@functools.lru_cache(maxsize=None)
def _powerlaw(n: int):
	"""Phase 9's graph (``powerlaw_laplacian``), generated once a run: phases 14 and 16 load it again."""
	from benchmarks.matrices import powerlaw_laplacian

	return powerlaw_laplacian(n=n, m=4, seed=0)


def bsr_sketches(torch, ptt, dev, cell: dict) -> tuple:
	"""Phase 7: BASELINE config 3's calls on the BSR cell, float32."""

	t0 = time.perf_counter()
	S = _bsr_cell(**cell)
	t_gen = time.perf_counter() - t0
	t0 = time.perf_counter()
	op = ptt.BSROperator.from_scipy(S, blocksize=(cell["bs"], cell["bs"]), dtype=torch.float32, device=dev)
	torch.cuda.synchronize()
	t_bsr = time.perf_counter() - t0
	diag_s = S.diagonal().astype(np.float64)
	tr = float(diag_s.sum())
	emit({"phase": "bsr_build", "n": S.shape[0], "nnz": int(S.nnz), "tiles": int(op.blocks.shape[0]),
		"tile_bytes": op.blocks.numel() * op.blocks.element_size(), "generate_s": t_gen, "from_scipy_s": t_bsr, "trace": tr})
	calls = {
		"hutchpp": lambda: ptt.hutchpp(op, m=240, seed=7),
		"xtrace": lambda: ptt.xtrace(op, batch=64, converge="count", count=256, seed=7),
		"xnystrace": lambda: ptt.xnystrace(op, m=720, seed=7),
		"xdiag": lambda: ptt.xdiag(op, m=256, seed=7),
	}
	launches = 0
	for name, fn in calls.items():
		est, counts, copies, times, peak = _timed_calls(torch, fn)
		row = {"phase": "bsr_sketch", "call": name, "wall_s_median": statistics.median(times), "wall_s": times,
			"max_memory_allocated_bytes": peak, "launches": counts, "layout_copies": copies}
		if name == "xdiag":
			row["diag_rel_l2_err"] = float(np.linalg.norm(est - diag_s) / np.linalg.norm(diag_s))
			ok = bool(np.all(np.isfinite(est))) and est.shape == diag_s.shape
		else:
			row.update({"estimate": est, "exact": tr, "rel_err": abs(est - tr) / tr})
			ok = row["rel_err"] < TRACE_TOL
		emit(row)
		if not ok:
			raise AssertionError(f"{name} on the BSR cell is off: {row}")
		if counts["bsr_spmm"] != BSR_APPLIES[name]:
			raise AssertionError(f"{name}: bsr_spmm launched {counts['bsr_spmm']} times, expected {BSR_APPLIES[name]}")
		launches += counts["bsr_spmm"]
	return op, launches


def dia_sketches(torch, ptt, dev, side: int) -> tuple:
	"""Phase 8: sketch trace and diagonal estimators on the 3-D FEM Laplacian, float32."""
	from benchmarks.matrices import fem_laplacian_3d

	A = fem_laplacian_3d(side)
	op = ptt.DIAOperator.from_scipy(A, dtype=torch.float32, device=dev)
	d = A.diagonal().astype(np.float64)
	tr = float(d.sum())
	calls = {
		"hutchpp": lambda: ptt.hutchpp(op, m=240, seed=8),
		# Rademacher probes: with the default sphere probes the fluctuation of v_i²
		# adds a_ii² to each entry's variance, sqrt((2·49 + 6)/128)/7 ≈ 0.13 > DIAG_TOL.
		"xdiag": lambda: ptt.xdiag(op, m=256, pdf="rademacher", seed=8),
		"diagpp": lambda: ptt.diagpp(op, m=240, seed=8),
		"diag": lambda: ptt.diag(op, batch=64, converge="count", count=256, seed=8),
	}
	launches = 0
	for name, fn in calls.items():
		est, counts, copies, times, peak = _timed_calls(torch, fn)
		row = {"phase": "dia_sketch", "call": name, "n": A.shape[0], "offsets": list(op.offsets),
			"wall_s_median": statistics.median(times), "wall_s": times, "max_memory_allocated_bytes": peak, "launches": counts}
		if name == "hutchpp":
			row.update({"estimate": est, "exact": tr, "rel_err": abs(est - tr) / tr})
			ok = row["rel_err"] < TRACE_TOL
		else:
			row["diag_rel_l2_err"] = float(np.linalg.norm(est - d) / np.linalg.norm(d))
			ok = row["diag_rel_l2_err"] < DIAG_TOL
		emit(row)
		if not ok:
			raise AssertionError(f"{name} on the FEM cell is off: {row}")
		if counts["dia_stencil"] + counts["dia_stencil_t"] < 1:
			raise AssertionError(f"{name} launched no DIA stencil kernel: {counts}")
		launches += counts["dia_stencil"]
	if launches < 1:
		raise AssertionError("phase 8 never launched the node-major DIA stencil")
	diag_launches = counts["dia_stencil_t"]  # the last call, diag: one probe-major apply an iteration
	if diag_launches != 256:
		raise AssertionError(f"diag launched dia_stencil_t {diag_launches} times, expected 256")
	return op, launches, diag_launches


def mesh_laplacian(side: int):
	"""The 5-point mesh Laplacian plus the identity, ``I + T⊗I + I⊗T`` with ``T = tridiag(−1, 2, −1)``
	(``benchmarks/configs.py:31-38``, rebuilt here: that module imports jax)."""
	import scipy.sparse as sps

	T = sps.diags([-np.ones(side - 1), 2.0 * np.ones(side), -np.ones(side - 1)], [-1, 0, 1])
	eye = sps.identity(side)
	return (sps.identity(side * side) + sps.kron(T, eye) + sps.kron(eye, T)).tocsr().astype(np.float32)


def mesh_modes(side: int) -> np.ndarray:
	"""The eigenvalues ``μ_j = 2 − 2cos(πj/(side+1))`` of ``T``."""
	return 2.0 - 2.0 * np.cos(np.pi * np.arange(1, side + 1) / (side + 1))


def _csr_slq(torch, ptt, A, dev, seed: int):
	"""Phase 9's call on a scipy matrix: the matrix function built once, the estimate timed."""
	M = ptt.MatrixFunction(A, "log", deg=SLQ_CSR["deg"], orth=SLQ_CSR["orth"], dtype=torch.float32, device=dev)
	return M, lambda: ptt.hutch(M, batch=SLQ_CSR["batch"], converge="count", count=SLQ_CSR["count"], seed=seed)


def csr_slq(torch, ptt, dev) -> dict:
	"""Phase 9: BASELINE config 2 in its CSR form on a power-law graph, float32."""
	from benchmarks.matrices import powerlaw_laplacian
	from primate_tpu_torch.ops import _common

	t0 = time.perf_counter()
	L = _powerlaw(PL_N)
	t_gen = time.perf_counter() - t0
	t0 = time.perf_counter()
	M, run = _csr_slq(torch, ptt, L, dev, seed=9)
	torch.cuda.synchronize()
	t_dev = time.perf_counter() - t0
	op = M.operator
	est, counts, copies, times, peak = _timed_calls(torch, run)
	upper = float(np.sum(np.log(L.diagonal().astype(np.float64))))  # Hadamard: logdet ≤ Σ log L_ii
	row = {"phase": "csr_slq", "n": PL_N, "nnz": int(L.nnz), "max_row_nnz": int(np.diff(L.indptr).max()),
		"index_dtype": str(op.indices.dtype), "generate_s": t_gen, "to_device_s": t_dev, "estimate": est,
		"lower": 0.0, "upper": upper, "wall_s_median": statistics.median(times), "wall_s": times,
		"max_memory_allocated_bytes": peak, "launches": counts, "layout_copies": copies, **SLQ_CSR}
	# One CSR apply at k = 64: node-major, probe-major (matmat_t) and a probe-major view in, node-major out.
	k, n, item = 64, PL_N, 4
	idx = op.indices.element_size()
	gen = torch.Generator(device=dev)
	gen.manual_seed(9)
	V = torch.randn((n, k), generator=gen, device=dev, dtype=torch.float32)
	Vt = V.T.contiguous()
	_common.reset_launches()
	op.matmat_t(Vt)
	torch.cuda.synchronize()
	row["apply_layout_copies_probe_major"] = _common.LAYOUT_COPIES["csr_spmm"]
	b_ms, _ = bound(op.nnz * (item + idx) + (n + 1) * idx + 2 * n * k * item, 2 * op.nnz * k)
	row.update({"apply_k": k, "apply_node_major_ms": time_ms(torch, lambda: op.matmat(V), 10),
		"apply_probe_major_ms": time_ms(torch, lambda: op.matmat_t(Vt), 10),
		"apply_probe_major_view_in_ms": time_ms(torch, lambda: op.matmat(Vt.T), 10),
		# cuSPARSE on the column-major view as it lies: the route the port does not take.
		"library_column_major_ms": time_ms(torch, lambda: op.csr @ Vt.T, 10), "apply_bound_ms": b_ms})
	del V, Vt
	small = powerlaw_laplacian(n=PL_SMALL, m=4, seed=0)
	_, run_small = _csr_slq(torch, ptt, small, dev, seed=9)
	est_small = run_small()
	dense = torch.tensor(small.toarray(), dtype=torch.float64, device=dev)
	exact_small = float(torch.sum(torch.log(torch.linalg.eigvalsh(dense))))
	row.update({"small_n": PL_SMALL, "small_estimate": est_small, "small_exact": exact_small,
		"small_rel_err": abs(est_small - exact_small) / abs(exact_small)})
	emit(row)
	if not 0.0 <= est <= upper:
		raise AssertionError(f"CSR logdet {est} outside [0, {upper}]")
	if not row["small_rel_err"] < 0.05:
		raise AssertionError(f"CSR logdet at n={PL_SMALL} off by {row['small_rel_err']}")
	return row


def heat_curve(torch, ptt, dev):
	"""Phase 10: BASELINE config 4's heat-kernel curve on the mesh as a DIA operator, and the
	same mesh as scipy CSR through phase 9's logdet call; float32."""
	A = mesh_laplacian(MESH_SIDE)
	mu = mesh_modes(MESH_SIDE)
	op = ptt.DIAOperator.from_scipy(A, dtype=torch.float32, device=dev)
	deg, batch = 20, 32
	M = ptt.MatrixFunction(op, ptt.stacked("exp", -TAUS), deg=deg, orth=0)
	est, counts, copies, times, peak = _timed_calls(torch, lambda: ptt.hutch(M, batch=batch, converge="count", count=batch, seed=10))
	exact = np.array([np.exp(-t) * np.sum(np.exp(-t * mu)) ** 2 for t in TAUS])
	rel = np.abs(est - exact) / exact
	row = {"phase": "heat_curve", "n": A.shape[0], "offsets": list(op.offsets), "taus": TAUS.tolist(), "deg": deg,
		"probes": batch, "estimates": np.asarray(est).tolist(), "exact": exact.tolist(), "rel_err": rel.tolist(),
		"wall_s_median": statistics.median(times), "wall_s": times, "max_memory_allocated_bytes": peak, "launches": counts}
	_, run = _csr_slq(torch, ptt, A, dev, seed=11)
	logdet, csr_counts, csr_copies, csr_times, csr_peak = _timed_calls(torch, run)
	exact_logdet = float(np.sum(np.log(1.0 + mu[:, None] + mu[None, :])))
	row.update({"csr_logdet": logdet, "csr_logdet_exact": exact_logdet, "csr_rel_err": abs(logdet - exact_logdet) / exact_logdet,
		"csr_wall_s_median": statistics.median(csr_times), "csr_wall_s": csr_times, "csr_max_memory_allocated_bytes": csr_peak,
		"csr_layout_copies": csr_copies})
	emit(row)
	if not np.all(rel < 0.02):
		raise AssertionError(f"heat-kernel curve off its closed form: {rel}")
	for k in ("lanczos_dia_step", "lanczos_dia_residual"):
		if counts[k] != deg:  # one batch: one sweep for the whole family
			raise AssertionError(f"{k} launched {counts[k]} times for the heat curve, expected {deg}")
	if not row["csr_rel_err"] < 0.05:
		raise AssertionError(f"CSR logdet of the mesh off by {row['csr_rel_err']}")
	return op


def _mesh_heat_matrix(torch, dev, tau: float):
	"""``exp(−τT)`` (1000×1000) and its diagonal, by ``eigh`` in float64 on the card."""
	import scipy.sparse as sps

	T = sps.diags([-np.ones(MESH_SIDE - 1), 2.0 * np.ones(MESH_SIDE), -np.ones(MESH_SIDE - 1)], [-1, 0, 1]).toarray()
	w, U = torch.linalg.eigh(torch.tensor(T, dtype=torch.float64, device=dev))
	E = (U * torch.exp(-tau * w)) @ U.T
	return E, torch.diagonal(E)


def fav(torch, ptt, dev, op) -> dict:
	"""Phase 11: ``exp(−L) V`` on the mesh, one-pass and two-pass, float32, against the exact product."""
	deg, k = 20, 8
	n = op.shape[0]
	gen = torch.Generator(device=dev)
	gen.manual_seed(11)
	V = torch.randn((n, k), generator=gen, device=dev, dtype=torch.float32)
	E, _ = _mesh_heat_matrix(torch, dev, 1.0)
	X = V.double().T.reshape(k, MESH_SIDE, MESH_SIDE)
	exact = (np.exp(-1.0) * (E @ X @ E)).reshape(k, n).T  # vec(E X E) per column, row-major
	row = {"phase": "fav", "n": n, "k": k, "deg": deg}
	outs = {}
	for label, two_pass in (("one_pass", "auto"), ("two_pass", True)):
		M = ptt.MatrixFunction(op, "exp", t=-1.0, deg=deg, orth=0, two_pass=two_pass)
		Y, counts, _, times, peak = _timed_calls(torch, lambda: M.matmat(V))
		err = torch.linalg.vector_norm(Y.double() - exact, dim=0) / torch.linalg.vector_norm(exact, dim=0)
		outs[label] = Y
		want = deg * (2 if label == "two_pass" else 1)
		row.update({f"{label}_uses_two_pass": M._use_two_pass(k), f"{label}_rel_err_max": float(err.max()),
			f"{label}_wall_s_median": statistics.median(times), f"{label}_wall_s": times,
			f"{label}_max_memory_allocated_bytes": peak, f"{label}_launches": counts})
		if not float(err.max()) < 1e-4:
			raise AssertionError(f"f(A)V {label} off the exact product by {float(err.max())}")
		for kern in ("lanczos_dia_step", "lanczos_dia_residual"):
			if counts[kern] != want:
				raise AssertionError(f"{label}: {kern} launched {counts[kern]} times, expected {want}")
	if row["one_pass_uses_two_pass"]:
		raise AssertionError("two_pass='auto' should keep a 640 MB basis in one pass")
	agree = float(torch.linalg.vector_norm(outs["one_pass"] - outs["two_pass"]) / torch.linalg.vector_norm(outs["two_pass"]))
	row["routes_rel_diff"] = agree
	emit(row)
	if not agree < 1e-4:
		raise AssertionError(f"one- and two-pass f(A)V disagree by {agree}")
	return row


def heat_signature(torch, ptt, dev, op) -> dict:
	"""Phase 12: the heat-kernel signature ``diag(exp(−τL))`` for all τ from shared sweeps, float32."""
	deg, batch, iters = 20, 64, 8
	n = op.shape[0]
	M = ptt.MatrixFunction(op, ptt.stacked("exp", -TAUS), deg=deg, orth=0)
	est, counts, _, times, peak = _timed_calls(torch, lambda: ptt.diag(M, batch=batch, converge="count", count=iters, seed=12))
	if est.shape != (len(TAUS), n):
		raise AssertionError(f"heat-kernel signature has shape {est.shape}, expected {(len(TAUS), n)}")
	errs = []
	for i, tau in enumerate(TAUS):
		_, d = _mesh_heat_matrix(torch, dev, float(tau))
		exact = (np.exp(-tau) * torch.outer(d, d).reshape(-1)).cpu().numpy()
		errs.append(float(np.linalg.norm(est[i] - exact) / np.linalg.norm(exact)))
	per_iter = deg * (2 if M._use_two_pass(batch) else 1)
	row = {"phase": "heat_signature", "n": n, "taus": TAUS.tolist(), "deg": deg, "batch": batch, "iterations": iters,
		"rel_l2_err": errs, "two_pass": M._use_two_pass(batch), "wall_s_median": statistics.median(times), "wall_s": times,
		"max_memory_allocated_bytes": peak, "launches": counts}
	emit(row)
	if not all(e < DIAG_TOL for e, tau in zip(errs, TAUS) if tau <= 1.0):
		raise AssertionError(f"heat-kernel signature off: {errs}")
	for kern in ("lanczos_dia_step", "lanczos_dia_residual"):
		if counts[kern] != iters * per_iter:
			raise AssertionError(f"{kern} launched {counts[kern]} times, expected {iters * per_iter}")
	return row


def _dirichlet_bands(torch, theta, n: int, dev):
	"""Row-aligned bands of ``e^{θ₀}·tridiag(−1, 2, −1) + e^{θ₁}·I`` (offsets −1, 0, 1), computed from θ."""
	a, b = torch.exp(theta[0]), torch.exp(theta[1])
	one = torch.ones(n, dtype=theta.dtype, device=dev)
	lo, hi = one.clone(), one.clone()
	lo[0], hi[-1] = 0.0, 0.0  # the unused ends of the off-diagonal bands
	return torch.stack([-a * lo, (2 * a + b) * one, -a * hi])


def _gp_kernel_checks(torch, K0, Zt, Wt, x, y) -> dict:
	"""Phase 13's kernels and kernel Functions against their plain versions on the run's own
	operator and blocks, relative to the largest entry: the probe-major stencil on a probe
	chunk ``Zt (64, n)`` (CG's apply and the pullback's forward) and on the solve's ``x (1, n)``;
	the node-major stencil on ``x`` as ``(n, 1)`` (the solve's pullback); the band and input
	gradients of both Functions (adjoint apply and band reduction) against autograd through the
	plain versions, with the chunk's ``Wt = K⁻¹Z`` and ``y`` as the cotangents."""
	from primate_tpu_torch.ops import autograd as kad
	from primate_tpu_torch.ops import dia

	offs, offsets = K0.offsets_t, K0.offsets
	offs_host = offs.cpu()
	errs = {}
	with torch.no_grad():
		for label, blk in (("dia_stencil_t_64xn", Zt), ("dia_stencil_t_1xn", x[None, :])):
			errs[label] = _rel_err(torch, K0.matmat_t(blk), dia.dia_stencil_t_ref(K0.bands, offs_host, blk))[1]
		errs["dia_stencil_nx1"] = _rel_err(torch, K0.matmat(x[:, None]), dia.dia_stencil_ref(K0.bands, offs_host, x[:, None]))[1]
	b = K0.bands.detach().requires_grad_(True)
	for label, fn, plain, v, G in (
		("dia_stencil_t_grad_64xn", kad.dia_stencil_t_ad, dia.dia_stencil_t_ref, Zt, Wt),
		("dia_stencil_grad_nx1", kad.dia_stencil_ad, dia.dia_stencil_ref, x[:, None], y[:, None]),
	):
		v = v.detach().requires_grad_(True)
		got = torch.autograd.grad(fn(b, v, offs, offsets), (b, v), G)
		want = torch.autograd.grad(plain(b, offs_host, v), (b, v), G)
		errs[label] = _grad_err(torch, got, want)[1]
		del got, want
	return errs


def gp_nll(torch, ptt, dev, n: int = N_LARGE, reps: int = 3) -> dict:
	"""Phase 13: BASELINE config 5 on one card, the GP negative log-likelihood and its θ
	gradient at n = 10M, float32: logdet, yᵀK⁻¹y and each gradient component against the
	closed forms through T's DST-I eigenbasis; the kernels at the shapes of the run against
	their plain versions."""
	import scipy.fft
	from primate_tpu_torch import autodiff
	from primate_tpu_torch.ops import _common
	from primate_tpu_torch.ops.autograd import _band_grad

	y64 = np.random.default_rng(13).normal(size=n)
	y = torch.tensor(y64, dtype=torch.float32, device=dev)

	def run():
		theta = torch.zeros(2, dtype=torch.float32, device=dev, requires_grad=True)
		K = ptt.DIAOperator(_dirichlet_bands(torch, theta, n, dev), (-1, 0, 1), (n, n))
		torch.cuda.synchronize()
		torch.cuda.reset_peak_memory_stats()
		_common.reset_launches()
		t0 = time.perf_counter()
		ld = autodiff.logdet(K, **GP)
		quad = y @ ptt.solve(K, y, rtol=GP["solver_rtol"])
		nll = 0.5 * (ld + quad + n * float(np.log(2 * np.pi)))
		torch.cuda.synchronize()
		t_fwd, fwd, peak_fwd = time.perf_counter() - t0, dict(_common.LAUNCHES), torch.cuda.max_memory_allocated()
		torch.cuda.reset_peak_memory_stats()
		_common.reset_launches()
		t0 = time.perf_counter()
		nll.backward()
		torch.cuda.synchronize()
		t_bwd, bwd, peak_bwd = time.perf_counter() - t0, dict(_common.LAUNCHES), torch.cuda.max_memory_allocated()
		values = (float(nll.detach()), float(ld.detach()), float(quad.detach()))
		return values, theta.grad.double().cpu().numpy(), t_fwd, t_bwd, fwd, bwd, peak_fwd, peak_bwd, K

	(nll, ld, quad), grad, _, _, fwd, bwd, peak_fwd, peak_bwd, K = run()  # the counted run, also the warm-up
	walls = [run()[2:4] for _ in range(reps)]
	lam = 2.0 - 2.0 * np.cos(np.arange(1, n + 1) * np.pi / (n + 1))
	yh2 = scipy.fft.dst(y.double().cpu().numpy(), type=1, norm="ortho") ** 2
	den = lam + 1.0  # a λ + b at θ = (0, 0)
	ld_exact, quad_exact = float(np.sum(np.log(den))), float(np.sum(yh2 / den))
	exact = 0.5 * (ld_exact + quad_exact + n * np.log(2 * np.pi))
	exact_grad = np.array([0.5 * (np.sum(lam / den) - np.sum(lam * yh2 / den**2)), 0.5 * (np.sum(1.0 / den) - np.sum(yh2 / den**2))])
	rel_ld, rel_quad = abs(ld - ld_exact) / abs(ld_exact), abs(quad - quad_exact) / abs(quad_exact)
	rel, rel_grad = abs(nll - exact) / abs(exact), np.abs(grad - exact_grad) / np.abs(exact_grad)
	# The same solves once more with full=True, for their iteration counts: the two probe
	# chunks as the backward pass draws them, and the solve of y. Chunk 0 and its solution
	# W = K⁻¹Z (the backward's cotangent, up to scale) and the solve's x feed the kernel checks.
	from primate_tpu_torch.random import sample_isotropic
	from primate_tpu_torch.trace import _base_seed, batch_generator

	with torch.no_grad():
		K0 = ptt.DIAOperator(K.bands.detach(), K.offsets, K.shape)
		its, blocks = [], None
		for i in range(-(-GP["nv"] // GP["chunk"])):
			Z = sample_isotropic(batch_generator(_base_seed(GP["seed"]), i, dev), (n, GP["chunk"]), dtype=torch.float32)
			W, it, _ = ptt.cg(K0, Z, rtol=GP["solver_rtol"], full=True)
			its.append(it)
			if blocks is None:
				blocks = (Z.T.contiguous(), W.T.contiguous())
			del Z, W
		x, solve_it, _ = ptt.cg(K0, y, rtol=GP["solver_rtol"], full=True)
		Zt, Wt = blocks
		pullback_ms = time_ms(torch, lambda: _band_grad(Wt, Zt, K0.offsets, torch.float32, probe_major=True), 5)
		stencil_ms = time_ms(torch, lambda: K0.matmat_t(Zt), 5)
	kernel_errs = _gp_kernel_checks(torch, K0, Zt, Wt, x, y)
	del blocks, Zt, Wt, x
	row = {"phase": "gp_nll", "n": n, "dtype": "float32", **GP, "nll": nll, "exact": exact, "rel_err": rel,
		"logdet": ld, "logdet_exact": ld_exact, "logdet_rel_err": rel_ld,
		"quad": quad, "quad_exact": quad_exact, "quad_rel_err": rel_quad,
		"grad": grad.tolist(), "exact_grad": exact_grad.tolist(), "grad_rel_err": rel_grad.tolist(), "tol": GP_TOL,
		"forward_wall_s_median": statistics.median(w[0] for w in walls), "backward_wall_s_median": statistics.median(w[1] for w in walls),
		"forward_wall_s": [w[0] for w in walls], "backward_wall_s": [w[1] for w in walls],
		"cg_iterations_per_chunk": its, "cg_iterations_solve": solve_it,
		"forward_max_memory_allocated_bytes": peak_fwd, "backward_max_memory_allocated_bytes": peak_bwd,
		"forward_launches": fwd, "backward_launches": bwd, "band_pullback_ms": pullback_ms, "stencil_t_ms": stencil_ms,
		"kernel_rel_err": kernel_errs, "kernel_tol": STENCIL_TOL["float32"]}
	emit(row)
	if not all(e <= STENCIL_TOL["float32"] for e in kernel_errs.values()):
		raise AssertionError(f"a kernel of the GP path disagrees with its plain version at the run's shapes: {kernel_errs}")
	if not (rel_ld < GP_TOL and rel_quad < GP_TOL and rel < GP_TOL and np.all(rel_grad < GP_TOL)):
		raise AssertionError(f"GP NLL terms or its gradient off the closed forms: {row}")
	for k in ("lanczos_dia_step", "lanczos_dia_residual", "dia_stencil_t"):
		if fwd[k] < 1:
			raise AssertionError(f"the forward pass launched no {k}")
	if bwd["dia_stencil_t"] < 1:
		raise AssertionError("the backward pass launched no dia_stencil_t")
	return row


def batched_cg(torch, ptt, dev) -> dict:
	"""Phase 14: batched CG on phase 9's 1M power-law graph (eigenvalues ≥ 1 by its shift),
	64 Rademacher right-hand sides, float32, with the Jacobi and the Nyström preconditioner."""
	from primate_tpu_torch.random import sample_isotropic

	L = _powerlaw(PL_N)
	op = ptt.CSROperator.from_scipy(L, dtype=torch.float32, device=dev)
	op64 = ptt.CSROperator.from_scipy(L, dtype=torch.float64, device=dev)
	gen = torch.Generator(device=dev)
	gen.manual_seed(14)
	B = sample_isotropic(gen, (PL_N, CG_RHS), pdf="rademacher", dtype=torch.float32)
	b_norm = torch.linalg.vector_norm(B.double(), dim=0).cpu().numpy()
	row = {"phase": "batched_cg", "n": PL_N, "nnz": int(L.nnz), "rhs": CG_RHS, "rtol": CG_RTOL}
	maxiter = 2000
	solves = (("jacobi", dict(precond="jacobi")), ("nystrom", dict(precond="nystrom", precond_rank=64, precond_seed=14)))
	for label, kw in solves:
		torch.cuda.synchronize()
		t0 = time.perf_counter()
		X, it, res = ptt.cg(op, B, rtol=CG_RTOL, maxiter=maxiter, full=True, **kw)
		torch.cuda.synchronize()
		wall = time.perf_counter() - t0
		with torch.no_grad():  # the residual of the returned X, in float64
			true = torch.linalg.vector_norm(B.double() - op64.matmat(X.double()), dim=0).cpu().numpy()
		true_rel = true / b_norm
		row.update({f"{label}_wall_s": wall, f"{label}_iterations": it, f"{label}_reported_rel_residual_max": float(np.max(res / b_norm)),
			f"{label}_true_rel_residual_max": float(true_rel.max()),
			# How far CG's recursive residual (what full=True reports, as in JAX) drifts from the true one.
			f"{label}_reported_vs_true_residual_max": float(np.max(np.abs(res - true) / true))})
		if not (it < maxiter and np.all(res <= CG_RTOL * b_norm * (1 + 1e-3)) and np.all(true_rel <= 2 * CG_RTOL)):
			emit(row)
			raise AssertionError(f"{label} CG did not converge to ‖B − AX‖/‖B‖ ≤ 2·rtol in every column: {row}")
		del X
	emit(row)
	return row


def _integral(y, t) -> float:
	"""Trapezoid rule of ``y`` over the grid ``t``."""
	y, t = np.asarray(y, np.float64), np.asarray(t, np.float64)
	return float(np.sum((y[1:] + y[:-1]) * np.diff(t)) / 2.0)


def check_complex_kernels(torch, dia, op, dev, reps: int = 10) -> dict:
	"""Phase 15, call 1: the complex stencils against their plain versions on the card, complex64
	and complex128, on the Hamiltonian's own bands at the cell's shapes (the 16 × n probe-major
	block of the KPM and Lanczos sweeps, an n × 64 node-major block) and at awkward shapes (1, 7,
	13 and 65 probes, n odd, offsets at and past n, a block one element into its buffer); the
	cell shapes timed beside their bound, their plain version and the complex cuSPARSE product, complex64 and
	complex128. Each launch that must take the complex64 scalar path is
	counted in ``SCALAR_LAUNCHES``."""
	from primate_tpu_torch.ops import _common

	gen = torch.Generator(device=dev)
	gen.manual_seed(150)
	n, n_d = op.shape[0], len(op.offsets)
	offs, offs_host = op.offsets_t, op.offsets_t.cpu()
	out = {}

	def crandn(shape, dtype):
		return torch.view_as_complex(torch.randn(tuple(shape) + (2,), generator=gen, device=dev, dtype=dtype.to_real()))

	def check(label, name, kern, plain, dtype, scalar: bool, timed=None, library=None):
		tname = str(dtype).removeprefix("torch.")
		before = _common.SCALAR_LAUNCHES[name]
		got, want = kern(), plain()
		torch.cuda.synchronize()
		took_scalar = _common.SCALAR_LAUNCHES[name] - before
		err, rel = _rel_err(torch, got, want)
		del got
		row = {"phase": "tight_binding_kernel_check", "kernel": name, "shape": label, "dtype": tname, "max_abs_err": err,
			"rel_err": rel, "tol": CPLX_TOL[tname], "scalar_launches": took_scalar}
		if timed is not None:
			bytes_, flops = timed
			ms, plain_ms = _timed_pair(torch, kern, plain, reps)
			b_ms, b_by = bound(bytes_, flops)
			lib_ms, lib_note = library_ms(torch, library, want, reps)
			row.update({"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "GBps": bytes_ / ms / 1e6,
				"library_ms": lib_ms, "library_rel_err_or_error": lib_note})
			pre = "c64_" if tname == "complex64" else "c128_"
			out.setdefault(name, {}).update({f"{pre}max_abs_err": err, f"{pre}ms": ms, f"{pre}plain_ms": plain_ms,
				f"{pre}bound_ms": b_ms, f"{pre}bound_by": b_by, f"{pre}library_ms": lib_ms})
		emit(row)
		if not rel <= CPLX_TOL[tname]:
			raise AssertionError(f"complex {name} disagrees with its plain version: {row}")
		if took_scalar != int(scalar):
			raise AssertionError(f"complex {name} took its scalar path {took_scalar} times, expected {int(scalar)}: {row}")

	for dtype in (torch.complex64, torch.complex128):
		c64 = dtype == torch.complex64
		item = 8 if c64 else 16
		bands = op.bands.to(dtype)
		A_csr = csr_of_dia(torch, bands, op.offsets, n)
		# A complex multiply-add is 8 real operations; complex64 runs them in float32.
		X = crandn((TB_NV, n), dtype)
		check("cell_probe_major", "dia_stencil_t", lambda: dia.dia_stencil_t(bands, offs, X),
			lambda: dia.dia_stencil_t_ref(bands, offs_host, X), dtype, False,
			timed=((2 * TB_NV * n + n_d * n) * item, 8 * n_d * TB_NV * n), library=lambda: (A_csr @ X.T).T)
		del X
		V = crandn((n, 64), dtype)
		check("cell_node_major", "dia_stencil", lambda: dia.dia_stencil(bands, offs, V),
			lambda: dia.dia_stencil_ref(bands, offs_host, V), dtype, False,
			timed=((2 * 64 * n + n_d * n) * item, 8 * n_d * 64 * n), library=lambda: A_csr @ V)
		del V, A_csr, bands
		# (probes, n, offsets, lead): a 16-byte vector holds 2 complex64 and 1 complex128, so
		# complex64 takes the scalar path where a row length is odd or the block starts one
		# element into its buffer, and complex128 never does.
		for nv, m, offsets, lead in ((1, 12_001, (-10_001, -1, 0, 1, 10_001), 0), (7, 3001, (-200, -7, 0, 7, 200), 0),
				(65, 5000, (-5000, -4999, -1, 0, 1, 4999, 5000, 6000), 0), (13, 12_000, (-10_000, -7, 0, 3, 10_000), 1)):
			b = crandn((len(offsets), m), dtype)
			o = torch.tensor(offsets, dtype=torch.int64, device=dev)
			x = crandn((lead + nv * m,), dtype)[lead:].view(nv, m)
			v = crandn((lead + m * nv,), dtype)[lead:].view(m, nv)
			label = f"nv{nv}_n{m}" + ("_misaligned" if lead else "")
			check(label, "dia_stencil_t", lambda: dia.dia_stencil_t(b, o, x), lambda: dia.dia_stencil_t_ref(b, o.cpu(), x), dtype,
				c64 and (m % 2 == 1 or lead == 1))
			check(label, "dia_stencil", lambda: dia.dia_stencil(b, o, v), lambda: dia.dia_stencil_ref(b, o.cpu(), v), dtype,
				c64 and (nv % 2 == 1 or lead == 1))
	return out


# The complex step's tolerances beside CPLX_TOL (v and w: max-abs error over max|out|): α over
# ‖q‖·‖w‖ of its probe (the Cauchy-Schwarz bound of |α|, which a Hermitian probe's α may sit far
# below), β' relative.
CPLX_AB_TOL = {"complex64": 1e-5, "complex128": 1e-12}
# The complex step's awkward shapes (probes, n, offsets, lead): offsets inside, at and past 16 rows
# and at and past n, 9 diagonals (two chunks of pass A's band registers); 7 probes; a block one
# element into its buffer; 12 diagonals with far offsets that are even (256) and odd (258) multiples of
# complex64's 2-element vector and not multiples (255) and wrap offsets near ±n; n odd and misaligned.
CPLX_STEP_SHAPES = (
	(13, 3001, (-200, -17, -16, -7, 0, 7, 16, 17, 200), 0),
	(7, 12_000, (-12_000, -10_000, -1, 0, 1, 10_000, 11_999), 0),
	(9, 5000, (-5000, -4999, -1, 0, 1, 4999, 5000, 6000), 1),
	(16, 65_536, (-65_536 + 256, -258, -256, -255, -17, -1, 1, 16, 255, 256, 258, 65_536 - 256), 0),
	(7, 4097, (-4097 + 5, -64, -63, -1, 0, 1, 63, 64, 4097 - 5), 1),
)


def check_complex_step_kernels(torch, dia, op, dev, reps: int = 10) -> dict:
	"""Phase 15, call 1 (continued): the complex step passes (``lanczos_dia_step``, pass A, and
	``lanczos_dia_residual``, pass B) against the plain step on the card, complex64 and complex128. At
	the cell's shape (16 probes, the Hamiltonian's own bands) two whole flat steps from a mid-sweep
	state whose probe 0 broke down (its divisor inf: q = 0, its α and β zero), each from the same blocks
	and state as the plain step, then pass A, pass B and the step timed beside their bounds and plain
	versions; pass A alone (``lanczos_dia_step``, the ``orth > 0`` route), its ``w`` equal to the plain
	version's bit for bit. At the awkward shapes of ``CPLX_STEP_SHAPES`` two whole steps. Returns the
	complex64 cell numbers under ``c64_`` keys, the complex128 ones under ``c128_``."""
	from primate_tpu_torch.ops import _common
	from primate_tpu_torch.ops._build import load_library

	lib = load_library()
	gen = torch.Generator(device=dev)
	gen.manual_seed(151)
	out = {}

	def crandn(shape, dtype):
		return torch.view_as_complex(torch.randn(tuple(shape) + (2,), generator=gen, device=dev, dtype=dtype.to_real()))

	def unit(X):
		return X.div_(torch.linalg.vector_norm(X, dim=1, keepdim=True))

	def mid_sweep_state(nv, r):
		st = dia.lanczos_state(nv, r, dev)
		st.scal[dia.DIV_CUR] = torch.rand(nv, generator=gen, device=dev, dtype=r) + 0.5
		st.scal[dia.DIV_PREV] = torch.rand(nv, generator=gen, device=dev, dtype=r) + 0.5
		st.scal[dia.BETA] = torch.rand(nv, generator=gen, device=dev, dtype=r) + 0.5
		st.scal[dia.DIV_CUR, 0], st.scal[dia.BETA, 0], st.scal[dia.DONE, 0] = torch.inf, 1e-9, 1.0
		return st

	def two_steps(label, bands, offs, offs_host, v_cur, v_prev, dtype, scalar: bool) -> dict:
		"""Two whole steps, kernels against the plain step from the same blocks and state each time."""
		tname, r = str(dtype).removeprefix("torch."), dtype.to_real()
		nv = v_cur.shape[0]
		apply_ref = lambda q: dia.dia_stencil_t_ref(bands, offs_host, q)  # noqa: E731
		st = mid_sweep_state(nv, r)
		errs_v, errs_a, errs_ar, share_a, errs_b, bits, finite, done_ok = [], [], [], [], [], 0, True, True
		scalar_before, before = dict(_common.SCALAR_LAUNCHES), dict(_common.LAUNCHES)
		for _ in range(2):
			st_ref = dia.LanczosState(st.scal.clone(), torch.zeros(1, dtype=torch.int32, device=dev))
			ab, ab_ref = torch.empty((2, nv), dtype=r, device=dev), torch.empty((2, nv), dtype=r, device=dev)
			v = dia.lanczos_dia_sweep_step(bands, offs, v_cur, v_prev, st, ab[0], ab[1], 1e-8)
			v_ref = dia.lanczos_sweep_step_ref(apply_ref, v_cur, v_prev, st_ref, ab_ref[0], ab_ref[1], 1e-8)
			torch.cuda.synchronize()
			q = v_cur / st_ref.scal[dia.DIV_PREV, :, None]  # the step's q (the state has advanced)
			scale = torch.linalg.vector_norm(q, dim=1) * torch.linalg.vector_norm(v_ref + st_ref.scal[dia.ALPHA, :, None] * q, dim=1)
			errs_v.append(_rel_err(torch, v, v_ref))
			errs_a.append(float(((ab[0] - ab_ref[0]).abs() / scale.clamp_min(1e-30))[1:].max()))
			errs_ar.append(float(((ab[0] - ab_ref[0]).abs() / ab_ref[0].abs().clamp_min(1e-30))[1:].max()))
			share_a.append(float((ab_ref[0].abs() / scale.clamp_min(1e-30))[1:].min()))
			errs_b.append(float(((ab[1] - ab_ref[1]).abs() / ab_ref[1].abs())[1:].max()))
			bits += int((v != v_ref).sum())
			finite = finite and bool(torch.isfinite(torch.view_as_real(v)).all())
			done_ok = done_ok and bool(ab[0, 0] == 0 and ab[1, 0] == 0) and torch.equal(st.scal[dia.DONE], st_ref.scal[dia.DONE])
			v_prev, v_cur = v_cur, v
			del q, v_ref, scale
		launched = {k: _common.LAUNCHES[k] - before[k] for k in ("lanczos_dia_step", "lanczos_dia_residual", "dia_stencil_t")}
		took_scalar = {k: _common.SCALAR_LAUNCHES[k] - scalar_before[k] for k in ("lanczos_dia_step", "lanczos_dia_residual")}
		rel_v, rel_a, rel_b = max(e[1] for e in errs_v), max(errs_a), max(errs_b)
		row = {"phase": "tight_binding_step_check", "shape": label, "nv": nv, "n": v_cur.shape[1], "dtype": tname,
			"v_max_abs_err": max(e[0] for e in errs_v), "v_rel_err": rel_v, "v_entries_differing_in_bits": bits,
			"alpha_err_over_q_w": rel_a, "alpha_rel_err": max(errs_ar), "alpha_over_q_w_min": min(share_a),
			"beta_rel_err": rel_b, "tol": CPLX_TOL[tname], "ab_tol": CPLX_AB_TOL[tname],
			"launches": launched, "scalar_launches": took_scalar, "done_probe_ok": done_ok}
		emit(row)
		if not (rel_v <= CPLX_TOL[tname] and rel_a <= CPLX_AB_TOL[tname] and rel_b <= CPLX_AB_TOL[tname] and finite and done_ok
			and launched == {"lanczos_dia_step": 2, "lanczos_dia_residual": 2, "dia_stencil_t": 0}):
			raise AssertionError(f"the complex step kernels disagree with the plain step: {row}")
		# A misaligned start stays in the second step's v_prev, so both steps take the scalar path.
		if took_scalar != {"lanczos_dia_step": 2 * int(scalar), "lanczos_dia_residual": 2 * int(scalar)}:
			raise AssertionError(f"the complex step took its scalar path {took_scalar} times, expected {2 * int(scalar)}: {row}")
		return row

	n, n_d = op.shape[0], len(op.offsets)
	offs, offs_host = op.offsets_t, op.offsets_t.cpu()
	for dtype in (torch.complex64, torch.complex128):
		tname, r = str(dtype).removeprefix("torch."), dtype.to_real()
		key, item = ("c64" if dtype == torch.complex64 else "c128"), (8 if dtype == torch.complex64 else 16)
		bands = op.bands.to(dtype)
		nv = TB_NV
		v_cur, v_prev = unit(crandn((nv, n), dtype)), unit(crandn((nv, n), dtype))
		cell = two_steps("cell", bands, offs, offs_host, v_cur, v_prev, dtype, False)
		# H's spectrum is symmetric about 0, so a random probe's α nearly cancels (|α| far below ‖q‖·‖w‖)
		# and its relative error says little. From q ∝ (H + 2)x, α is near 2/d² (d the probe's divisor):
		# α and β relative to the plain step's, and pass A's α and the plain pass's against a float64 sum
		# of the same w.
		x = crandn((nv, n), dtype)
		q_s = unit(dia.dia_stencil_t_ref(bands, offs_host, x).add_(x, alpha=2.0))
		del x
		shifted = two_steps("cell_shifted_start", bands, offs, offs_host, q_s, v_prev, dtype, False)
		beta = torch.rand(nv, generator=gen, device=dev, dtype=r) + 0.5
		w, alpha = dia.lanczos_dia_step(bands, offs, q_s, v_prev, beta)
		w_ref, alpha_ref = dia.lanczos_dia_step_ref(bands, offs_host, q_s, v_prev, beta)
		wide = torch.complex128
		exact = dia.row_dot(q_s.to(wide), w.to(wide))
		torch.cuda.synchronize()
		emit({"phase": "tight_binding_pass_a_alpha", "shape": "cell_shifted_start", "dtype": tname,
			"w_equal": bool(torch.equal(w, w_ref)),
			"alpha_rel_err_vs_float64": float(((alpha.double() - exact) / exact).abs().max()),
			"plain_alpha_rel_err_vs_float64": float(((alpha_ref.double() - exact) / exact).abs().max()),
			"alpha_rel_err": float(((alpha - alpha_ref) / alpha_ref).abs().max())})
		if not shifted["alpha_rel_err"] <= CPLX_AB_TOL[tname]:
			raise AssertionError(f"complex step's α off the plain step's from a non-cancelling start: {shifted}")
		del w, w_ref, q_s, exact
		out.setdefault("lanczos_dia_step", {}).update({f"{key}_alpha_rel_err": shifted["alpha_rel_err"],
			f"{key}_beta_rel_err": shifted["beta_rel_err"]})
		# Pass A alone (orth > 0): w and α from unit q, β.
		beta = torch.rand(nv, generator=gen, device=dev, dtype=r) + 0.5
		w, alpha = dia.lanczos_dia_step(bands, offs, v_cur, v_prev, beta)
		w_ref, alpha_ref = dia.lanczos_dia_step_ref(bands, offs_host, v_cur, v_prev, beta)
		torch.cuda.synchronize()
		err_w = _rel_err(torch, w, w_ref)
		err_alpha = float(((alpha - alpha_ref).abs() / torch.linalg.vector_norm(w_ref, dim=1)).max())
		as_int = torch.int32 if dtype == torch.complex64 else torch.int64
		bits_w = int((torch.view_as_real(w).view(as_int) != torch.view_as_real(w_ref).view(as_int)).sum())
		del w, w_ref
		# Timed: pass A, pass B and the whole step, kernels in the sweep's mode, beside the plain passes.
		apply_ref = lambda q: dia.dia_stencil_t_ref(bands, offs_host, q)  # noqa: E731
		st, st_ref = mid_sweep_state(nv, r), mid_sweep_state(nv, r)
		ab = torch.empty((2, nv), dtype=r, device=dev)
		w_a, partial, gx, vec = dia._launch_pass_a(lib, bands, offs, v_cur, v_prev, st.scal, st.ticket, ab[0])
		w_b_ref = w_a.clone()
		timed = {
			"lanczos_dia_step": (
				lambda: dia._launch_pass_a(lib, bands, offs, v_cur, v_prev, st.scal, st.ticket, ab[0]),
				lambda: dia.lanczos_sweep_pass_a_ref(apply_ref, v_cur, v_prev, st_ref, ab[0]),
				(3 * nv * n + n_d * n) * item, (8 * n_d + 12) * nv * n),
			"lanczos_dia_residual": (
				lambda: dia._launch_pass_b(lib, v_cur, w_a, st, partial, ab[1], 1e-8, gx, vec),
				lambda: dia.lanczos_sweep_pass_b_ref(v_cur, w_b_ref, st_ref, ab[1], 1e-8),
				3 * nv * n * item, 10 * nv * n),
			"whole_step": (
				lambda: dia.lanczos_dia_sweep_step(bands, offs, v_cur, v_prev, st, ab[0], ab[1], 1e-8),
				lambda: dia.lanczos_sweep_step_ref(apply_ref, v_cur, v_prev, st_ref, ab[0], ab[1], 1e-8),
				(6 * nv * n + n_d * n) * item, (8 * n_d + 22) * nv * n),
		}
		row = {"phase": "tight_binding_step_timing", "shape": "cell", "nv": nv, "n": n, "dtype": tname, "grid_x": gx,
			"vector_path": vec, "pass_a_alone_w_rel_err": err_w[1], "pass_a_alone_alpha_err_over_w": err_alpha,
			"pass_a_alone_w_entries_differing_in_bits": bits_w}
		errs = {"lanczos_dia_step": max(err_w[0], cell["v_max_abs_err"]), "lanczos_dia_residual": cell["v_max_abs_err"]}
		for k, (kern, plain, bytes_, flops) in timed.items():
			ms, plain_ms = _timed_pair(torch, kern, plain, reps)
			b_ms, b_by = bound(bytes_, flops, FP32_FLOP_PER_S if dtype == torch.complex64 else FP64_FLOP_PER_S)
			row.update({f"{k}_ms": ms, f"{k}_plain_ms": plain_ms, f"{k}_bound_ms": b_ms, f"{k}_bound_by": b_by,
				f"{k}_GBps": bytes_ / ms / 1e6, f"{k}_share_of_bound": b_ms / ms})
			if k != "whole_step":
				out.setdefault(k, {}).update({f"{key}_max_abs_err": errs[k], f"{key}_ms": ms, f"{key}_plain_ms": plain_ms,
					f"{key}_bound_ms": b_ms, f"{key}_bound_by": b_by, f"{key}_library_ms": None})
		emit(row)
		if not (err_w[1] <= CPLX_TOL[tname] and err_alpha <= CPLX_AB_TOL[tname] and bits_w == 0):
			raise AssertionError(f"complex pass A alone disagrees with its plain version: {row}")
		del w_a, w_b_ref, partial, v_cur, v_prev, bands, st, st_ref
		torch.cuda.empty_cache()
		# Awkward shapes: (probes, n, offsets, lead); complex64 takes the scalar path where n is odd or
		# the block starts one element into its buffer, complex128 never does.
		for nv, m, offsets, lead in CPLX_STEP_SHAPES:
			b = crandn((len(offsets), m), dtype)
			o = torch.tensor(offsets, dtype=torch.int64, device=dev)
			vc = unit(crandn((lead + nv * m,), dtype)[lead:].view(nv, m))
			vp = unit(crandn((lead + nv * m,), dtype)[lead:].view(nv, m))
			two_steps(f"nv{nv}_n{m}" + ("_misaligned" if lead else ""), b, o, o.cpu(), vc, vp, dtype,
				dtype == torch.complex64 and (m % 2 == 1 or lead == 1))
	return out


def _tb_calls(torch, ptt, dev, op, H) -> dict:
	"""Phase 15, calls 2-8, on the Hamiltonian as a complex64 DIA operator (and as complex CSR for call 8).
	Each call is counted (every launch count set to 0 just before it, read just after) and then timed."""
	from primate_tpu_torch import kpm

	n, alpha = op.shape[0], TB["alpha"]
	rows = {}

	def run(name, fn, **fields):
		value, counts, copies, times, peak = _timed_calls(torch, fn)
		rows[name] = {"phase": "tight_binding", "call": name, "n": n, "wall_s_median": statistics.median(times),
			"wall_s": times, "max_memory_allocated_bytes": peak, "launches": counts, "layout_copies": copies, **fields}
		return value, counts

	def done(name, ok: bool, **fields):
		rows[name].update(fields)
		emit(rows[name])
		if not ok:
			raise AssertionError(f"tight-binding call {name} is off: {rows[name]}")

	def launched(name, counts, want: dict):
		for k, v in want.items():
			if counts[k] != v:
				raise AssertionError(f"{name}: {k} launched {counts[k]} times, expected {v}: {counts}")

	lo, hi = ptt.operators.gershgorin_interval(op)
	if not (abs(lo + 4.0) <= 1e-5 and abs(hi - 4.0) <= 1e-5):
		raise AssertionError(f"Gershgorin interval of the Hofstadter model is [{lo}, {hi}], expected [-4, 4]")
	no_steps = {"lanczos_dia_step": 0, "lanczos_dia_residual": 0}

	# 2. tr H² = 4n and tr H⁴ = (28 + 8 cos 2πα)·n, by KPM with 8 moments on phase probes; the
	# limit is 10 standard deviations of the same probes' per-probe samples (ChebyshevFunction.quad).
	funs = [lambda x: x**2, lambda x: x**4]
	exact = np.array([4.0, 28.0 + 8.0 * np.cos(2.0 * np.pi * alpha)]) * n
	est, counts = run("kpm_trace", lambda: ptt.kpm_trace(op, funs, m=8, nv=TB_NV, damping="none", interval="gershgorin",
		pdf="phase", seed=152), m=8, nv=TB_NV)
	with torch.no_grad():
		per = ptt.ChebyshevFunction(op, funs, deg=8, damping="none", interval="gershgorin").quad(
			kpm._probes(op, TB_NV, "phase", 152)).double().cpu().numpy()
	sigma = per.std(axis=1, ddof=1) / np.sqrt(TB_NV)
	launched("kpm_trace", counts, {"dia_stencil_t": 7, **no_steps})
	done("kpm_trace", bool(np.all(np.abs(est - exact) <= 10.0 * sigma)), estimates=np.asarray(est).tolist(),
		exact=exact.tolist(), rel_err=(np.abs(est - exact) / exact).tolist(), sigma=sigma.tolist(),
		per_probe_mean_minus_estimate=(per.mean(axis=1) - est).tolist())

	# 3. The KPM density of states: mass 1, second moment tr H²/n = 4; its gaps counted as the example does.
	(ts, phi), counts = run("kpm_density", lambda: ptt.kpm_density(op, grid=512, m=512, nv=TB_NV, pdf="phase",
		interval="gershgorin", seed=153), grid=512, m=512, nv=TB_NV)
	mass, second = _integral(phi, ts), _integral(ts**2 * phi, ts)
	gaps = int(np.sum(np.diff((phi < 0.2 * phi.max()).astype(int)) == 1))
	launched("kpm_density", counts, {"dia_stencil_t": 511, **no_steps})
	done("kpm_density", abs(mass - 1.0) <= 1e-2 and abs(second - 4.0) <= 0.08, mass=mass, second_moment=second,
		gap_entries=gaps)

	# 4. Lanczos against Chebyshev on one 16-probe phase block, probe for probe; then the β sweep.
	gen = torch.Generator(device=dev)
	gen.manual_seed(154)
	V = ptt.sample_isotropic(gen, (n, TB_NV), pdf="phase", dtype=torch.complex64)
	M = ptt.MatrixFunction(op, "exp", t=-1.0, deg=40, orth=0)
	C = ptt.ChebyshevFunction(op, "exp", t=-1.0, deg=64, damping="none", interval="gershgorin")
	q_l, counts_l = run("lanczos_quad", lambda: M.quad(V), deg=40)
	q_c, counts_c = run("chebyshev_quad", lambda: C.quad(V), deg=64)
	launched("lanczos_quad", counts_l, {"dia_stencil_t": 0, "lanczos_dia_step": 40, "lanczos_dia_residual": 40})
	launched("chebyshev_quad", counts_c, {"dia_stencil_t": 63, **no_steps})
	q_l, q_c = q_l.double().cpu().numpy(), q_c.double().cpu().numpy()
	rel = float(np.max(np.abs(q_l - q_c) / np.abs(q_c)))
	done("lanczos_quad", True)
	done("chebyshev_quad", rel <= 1e-4, per_probe_rel_diff_max=rel, limit=1e-4)
	betas = np.array(TB_BETAS)
	sweep = ptt.MatrixFunction(op, ptt.stacked("exp", -betas), deg=48, orth=0)
	Z, counts = run("beta_sweep", lambda: ptt.hutch(sweep, pdf="phase", batch=16, converge="count", count=64, seed=155),
		betas=betas.tolist(), deg=48, batch=16, count=64)
	launched("beta_sweep", counts, {"dia_stencil_t": 0, "lanczos_dia_step": 48 * 4, "lanczos_dia_residual": 48 * 4})
	# The same traces from call 3's density: n ∫ e^{−βt} φ(t) dt.
	Z_dos = np.array([n * _integral(np.exp(-b * ts) * phi, ts) for b in betas])
	z_rel = np.abs(np.asarray(Z) - Z_dos) / Z_dos
	done("beta_sweep", bool(np.all(z_rel <= 0.02)), estimates=np.asarray(Z).tolist(), from_kpm_density=Z_dos.tolist(),
		rel_diff=z_rel.tolist())

	# 5. diag(H²) = 4 at every site, by phase probes through a degree-3 Chebyshev expansion. One
	# sample of site i errs by Re Σ_{j≠i} (H²)_ij conj(v_i) v_j, of variance Σ_{j≠i}|(H²)_ij|²/2 =
	# (4 + 4|1 + e^{2πiα}|²)/2. `count` counts iterations of `batch` probes, and diag returns the
	# mean of its K = count running ratios, which weighs iteration s by w_s = (1/K) Σ_{k≥s} 1/k: the
	# variance at a site is that of one sample times Σ_s w_s² / batch, and the relative L2 error is
	# its root over 4.
	iters, batch = 64, 16
	W2 = ptt.ChebyshevFunction(op, lambda x: x**2, deg=3, damping="none", interval="gershgorin")
	d, counts = run("diag_h2", lambda: ptt.diag(W2, pdf="phase", batch=batch, converge="count", count=iters, seed=156),
		batch=batch, count=iters)
	d = np.asarray(d, np.float64)
	off_sq = 4.0 + 4.0 * (2.0 + 2.0 * np.cos(2.0 * np.pi * alpha))
	w = np.cumsum((1.0 / np.arange(1, iters + 1))[::-1])[::-1] / iters
	spread = float(np.sqrt(off_sq / 2.0 * np.sum(w**2) / batch) / 4.0)
	rel_l2 = float(np.sqrt(np.mean((d - 4.0) ** 2)) / 4.0)
	launched("diag_h2", counts, {"dia_stencil_t": 2 * iters, **no_steps})
	done("diag_h2", abs(float(d.mean()) - 4.0) <= 1e-3 and abs(rel_l2 - spread) <= 0.1 * spread and d.shape == (n,),
		mean=float(d.mean()), rel_l2_err=rel_l2, expected_rel_l2_err=spread, sum_offdiag_sq_per_site=off_sq)
	# The example's LDOS: a Gaussian window at E = 0 (σ = 0.1, degree 256, Rayleigh-Ritz interval),
	# 4 iterations of 16 phase probes (the example: 192 of one). Its mean is the window's trace per
	# site, set beside the same window integrated against call 3's density.
	sig = 0.1
	window = ptt.ChebyshevFunction(op, lambda x: torch.exp(-(x**2) / (2 * sig**2)) / (sig * np.sqrt(2 * np.pi)), deg=256, seed=157)
	ldos, counts = run("ldos", lambda: ptt.diag(window, pdf="phase", batch=batch, converge="count", count=4, seed=3),
		deg=256, batch=batch, count=4, interval=list(window.interval))
	ldos = np.asarray(ldos, np.float64)
	ref = _integral(np.exp(-(ts**2) / (2 * sig**2)) / (sig * np.sqrt(2 * np.pi)) * phi, ts)
	launched("ldos", counts, {"dia_stencil_t": 255 * 4, **no_steps})
	done("ldos", bool(np.all(np.isfinite(ldos))) and ldos.shape == (n,) and abs(float(ldos.mean()) - ref) <= 0.2 * ref,
		mean=float(ldos.mean()), from_kpm_density=ref, std_over_mean=float(ldos.std() / ldos.mean()))

	# 6. The SLQ density on the complex sweep: mass 1, second moment 4 (plus the broadening's σ²).
	(ts6, phi6), counts = run("spectral_density", lambda: ptt.spectral_density(op, deg=64, nv=TB_NV, seed=158), deg=64, nv=TB_NV)
	mass6, second6 = _integral(phi6, ts6), _integral(ts6**2 * phi6, ts6)
	launched("spectral_density", counts, {"dia_stencil_t": 0, "lanczos_dia_step": 64, "lanczos_dia_residual": 64})
	done("spectral_density", abs(mass6 - 1.0) <= 1e-2 and abs(second6 - 4.0) <= 0.08, mass=mass6, second_moment=second6)

	# 7. Hutch++ on H·H: tr H² = 4n. The sketch's QR block is node-major, so each apply of the
	# composed operator to it is two complex dia_stencil launches; the probe blocks take dia_stencil_t.
	tr, counts = run("hutchpp_h2", lambda: ptt.hutchpp(op @ op, m=64, seed=159), m=64)
	launched("hutchpp_h2", counts, {"dia_stencil": 2, "dia_stencil_t": 4, **no_steps})
	done("hutchpp_h2", abs(tr - 4.0 * n) / (4.0 * n) <= 1e-2, estimate=tr, exact=4.0 * n, rel_err=abs(tr - 4.0 * n) / (4.0 * n))

	# 8. The same H as complex CSR (cuSPARSE) against the DIA operator, on call 4's block.
	op_csr = ptt.aslinop(H, dtype=torch.complex64, device=dev)
	C_csr = ptt.ChebyshevFunction(op_csr, "exp", t=-1.0, deg=64, damping="none", interval="gershgorin")
	q_csr, counts = run("csr_chebyshev_quad", lambda: C_csr.quad(V), deg=64)
	rel8 = float(np.max(np.abs(q_csr.double().cpu().numpy() - q_c) / np.abs(q_c)))
	if counts["dia_stencil_t"] != 0 or rows["csr_chebyshev_quad"]["layout_copies"]["csr_spmm"] != 2 * 63:
		raise AssertionError(f"the CSR quad did not take cuSPARSE once an apply: {rows['csr_chebyshev_quad']}")
	done("csr_chebyshev_quad", rel8 <= 1e-5, per_probe_rel_diff_to_dia_max=rel8, limit=1e-5)
	return rows


def tight_binding(torch, ptt, dia, dev) -> dict:
	"""Phase 15: the Hofstadter model of ``examples/tight_binding.py`` at 4,096,000 sites as a
	complex64 DIA operator: the complex stencils and step passes held to their plain versions (call 1),
	then the example's calls through the port (calls 2-8, ``_tb_calls``)."""
	t0 = time.perf_counter()
	H = hofstadter_csr(**TB)
	t_gen = time.perf_counter() - t0
	t0 = time.perf_counter()
	op = ptt.DIAOperator.from_scipy(H, dtype=torch.complex64, device=dev)
	torch.cuda.synchronize()
	t_dia = time.perf_counter() - t0
	n, ny = op.shape[0], TB["ny"]
	want = sorted(s * o for s in (1, -1) for o in (1, ny - 1, ny, (TB["nx"] - 1) * ny))
	emit({"phase": "tight_binding_build", "n": n, **TB, "nnz": int(H.nnz), "offsets": list(op.offsets),
		"band_bytes": op.bands.numel() * op.bands.element_size(), "generate_s": t_gen, "from_scipy_s": t_dia})
	if sorted(op.offsets) != want:
		raise AssertionError(f"Hofstadter offsets {op.offsets}, expected {want}")
	kernels = check_complex_kernels(torch, dia, op, dev)
	kernels.update(check_complex_step_kernels(torch, dia, op, dev))
	calls = _tb_calls(torch, ptt, dev, op, H)
	for k in ("dia_stencil_t", "dia_stencil", "lanczos_dia_step", "lanczos_dia_residual"):
		# the complex launches of calls 2-8, each counted from 0
		kernels[k]["c64_launches"] = sum(r["launches"][k] for r in calls.values())
	return kernels


# --- Phases 16-18: the host loader and auto_operator, the eigensolvers, rectangular spectra ---


def _walls(torch, fn, long_s: float = 5.0, reps: int = 3) -> tuple:
	"""The counted call (launch and copy counts from 0) and its walls: the median of ``reps`` synced
	calls after it as the warm-up, or the one run where it took over ``long_s`` seconds."""
	from primate_tpu_torch.ops import _common

	torch.cuda.synchronize()
	_common.reset_launches()
	t0 = time.perf_counter()
	out = fn()
	torch.cuda.synchronize()
	first = time.perf_counter() - t0
	launches, copies = dict(_common.LAUNCHES), dict(_common.LAYOUT_COPIES)
	if first > long_s:
		return out, launches, copies, [first]
	times = []
	for _ in range(reps):
		t0 = time.perf_counter()
		fn()
		torch.cuda.synchronize()
		times.append(time.perf_counter() - t0)
	return out, launches, copies, times


def _wall_keys(times) -> dict:
	return {"wall_s_median": statistics.median(times), "wall_s": times}


def _add(total: dict, counts: dict) -> None:
	for k, v in counts.items():
		total[k] = total.get(k, 0) + v


def _prep_row(info, times, counts) -> dict:
	return {"format": info.format, "perm": info.perm is not None, "bandwidth": info.bandwidth, "fill": info.fill,
		**_wall_keys(times), "launches": counts}


def host_prep(torch, ptt, dev) -> dict:
	"""Phase 16: the native loader (build, both ``from_scipy`` engines on the 10M tridiagonal and
	on the BSR cell, bit for bit) and ``auto_operator`` on a permuted 1M path Laplacian (then the
	flagship call on it), phase 9's power-law graph and the BSR cell. Returns the launches of
	the flagship call on the reordered operator."""
	from primate_tpu_torch import native

	t0 = time.perf_counter()
	native.require()  # builds the library (g++) and raises the compiler's error if it cannot
	emit({"phase": "native_build", "seconds": time.perf_counter() - t0, "library": native.library_path().name})

	def engines(name, build, same, n):
		out, secs = {}, {}
		for engine in ("native", "scipy"):
			torch.cuda.synchronize()
			t0 = time.perf_counter()
			out[engine] = build(engine)
			torch.cuda.synchronize()
			secs[engine] = time.perf_counter() - t0
		ok = same(out["native"], out["scipy"])
		emit({"phase": "prep_engines", "operator": name, "n": n, "native_s": secs["native"], "scipy_s": secs["scipy"], "identical": ok})
		if not ok:
			raise AssertionError(f"the native and scipy engines disagree on the {name} operator")

	L = build_laplacian(N_LARGE)
	engines("dia_tridiagonal", lambda e: ptt.DIAOperator.from_scipy(L, dtype=torch.float32, device=dev, engine=e),
		lambda a, b: a.offsets == b.offsets and bool(torch.equal(a.bands, b.bands)), N_LARGE)
	del L
	S = _bsr_cell(**BSR_CELL)
	bs = (BSR_CELL["bs"], BSR_CELL["bs"])
	engines("bsr_cell", lambda e: ptt.BSROperator.from_scipy(S, blocksize=bs, dtype=torch.float32, device=dev, engine=e),
		lambda a, b: all(bool(torch.equal(getattr(a, k), getattr(b, k))) for k in ("blocks", "indices", "indptr")), S.shape[0])
	torch.cuda.empty_cache()

	# auto_operator: a path Laplacian in a seeded random order comes back banded (RCM, DIA).
	n = PREP_PATH_N
	p = np.random.default_rng(16).permutation(n)
	P = build_laplacian(n)[p][:, p].tocsr()
	(op, info), counts, _, times = _walls(torch, lambda: ptt.auto_operator(P, dtype=torch.float32, device=dev))
	row = {"phase": "auto_operator", "matrix": "permuted_path", "n": n, "nnz": int(P.nnz), **_prep_row(info, times, counts)}
	M = ptt.MatrixFunction(op, "log", deg=DEG, orth=ORTH)
	est, flag_counts, _, flag_times = _walls(torch, lambda: ptt.hutch(M, batch=PROBES, converge="count", count=PROBES, seed=16))
	exact = exact_logdet(n)
	row.update({"logdet": est, "exact": exact, "rel_err": abs(est - exact) / abs(exact),
		"logdet_wall_s_median": statistics.median(flag_times), "logdet_wall_s": flag_times, "logdet_launches": flag_counts})
	emit(row)
	# Fill 1.0 up to the two missing corner entries: 3 bands of n over 3n − 2 nonzeros.
	if not (info.format == "dia" and info.perm is not None and info.bandwidth == 1 and abs(info.fill - 3.0 * n / P.nnz) < 1e-12):
		raise AssertionError(f"auto_operator on the permuted path chose {info}")
	if not row["rel_err"] < 0.05:
		raise AssertionError(f"logdet of the reordered path off by {row['rel_err']}")
	for k in ("lanczos_dia_step", "lanczos_dia_residual"):
		if flag_counts[k] != DEG:  # one batch of PROBES, as in phase 3
			raise AssertionError(f"{k} launched {flag_counts[k]} times on the reordered path, expected {DEG}")
	del op, M, P

	# The power-law graph and the BSR cell: reorder="auto" tries RCM and keeps the natural order.
	for name, A, want in (("powerlaw_graph", _powerlaw(PL_N), "csr"), ("bsr_cell", S, "bsr")):
		(op, info), counts, _, times = _walls(torch, lambda: ptt.auto_operator(A, dtype=torch.float32, device=dev))
		emit({"phase": "auto_operator", "matrix": name, "n": A.shape[0], "nnz": int(A.nnz), **_prep_row(info, times, counts)})
		if info.format != want or info.perm is not None:
			raise AssertionError(f"auto_operator on the {name} chose {info}, expected {want} in the natural order")
		del op
		torch.cuda.empty_cache()
	return flag_counts


def grid_laplacian(nx: int, ny: int):
	"""The Dirichlet 5-point Laplacian of the spectrum-slicing example (float32) and its eigenvalues
	``4 sin²(jπ/2(nx+1)) + 4 sin²(kπ/2(ny+1))``, sorted (``primate_tpu_torch.examples.spectrum_slicing``)."""
	from primate_tpu_torch.examples import spectrum_slicing as ex

	return ex.grid_laplacian(nx, ny).astype(np.float32), ex.grid_eigenvalues(nx, ny)


def _residuals(torch, op64, w, V):
	"""``‖Av − λv‖`` per pair in float64 on the card, each ``v`` normalised first."""
	V64 = V.double()
	V64 = V64 / torch.linalg.vector_norm(V64, dim=0, keepdim=True)
	return torch.linalg.vector_norm(op64.matmat(V64.contiguous()) - V64 * w.double()[None, :], dim=0).cpu().numpy()


def _check_plain(torch, label: str, got, want, dtype: str = "float32") -> float:
	"""A kernel route's result against its plain version on the same card tensors: the max-abs
	error over max|want|, which must be within ``STENCIL_TOL``."""
	err = _rel_err(torch, got, want)[1]
	if not err <= STENCIL_TOL[dtype]:
		raise AssertionError(f"{label}: the kernel route is {err} off its plain version (limit {STENCIL_TOL[dtype]})")
	return err


def separated_spectrum(n: int, k: int, seed: int):
	"""A banded ``Q D Qᵀ`` whose spectrum is known and whose ends are separated: ``D`` holds the
	top ``k`` eigenvalues ``10 − j/4``, the bottom ``k`` ``(j + 1)/10`` and the rest uniform in
	[1.5, 7.5], in a seeded order; ``Q`` is two layers of seeded 2×2 rotations, on the pairs
	(2i, 2i + 1) and then (2i + 1, 2i + 2), so ``Q D Qᵀ`` has 7 diagonals. A solver that misses
	the top or bottom ``k`` is at least 0.1 off; the mesh's top 8 lie within 1.1e-4 of each other.
	Returns the float32 CSR matrix and the eigenvalues, ascending."""
	import scipy.sparse as sps

	rng = np.random.default_rng(seed)
	ew = np.concatenate([10.0 - 0.25 * np.arange(k), 0.1 * np.arange(1, k + 1), rng.uniform(1.5, 7.5, n - 2 * k)])
	d = rng.permutation(ew)

	def rotations(first: int):
		i = np.arange(first, n - 1, 2)
		c, s = np.cos(th := rng.uniform(0.0, 2.0 * np.pi, i.size)), np.sin(th)
		rest = np.setdiff1d(np.arange(n), np.concatenate([i, i + 1]))
		rows = np.concatenate([i, i, i + 1, i + 1, rest])
		cols = np.concatenate([i, i + 1, i, i + 1, rest])
		return sps.csr_matrix((np.concatenate([c, -s, s, c, np.ones(rest.size)]), (rows, cols)), shape=(n, n))

	Q = rotations(1) @ rotations(0)
	return (Q @ sps.diags(d) @ Q.T).tocsr().astype(np.float32), np.sort(ew)


def _eigsh_calls(torch, ptt, label: str, op, exact, kw: dict, hold_ends: bool, total: dict) -> None:
	"""``eigsh`` LA and SA by LOBPCG and LA by thick restart on ``op`` (float32; ``exact`` its
	eigenvalues, ascending). Each pair lies within its float64 residual of the spectrum
	(Bauer-Fike); with ``hold_ends``, the eigenvalues also match the closed-form top or bottom
	``EIG_K`` within ``EIG_END_TOL``·‖A‖ and every residual is below ``EIG_RES_TOL``·‖A‖."""
	from primate_tpu_torch import eigen

	op64 = ptt.DIAOperator(op.bands.double(), op.offsets, op.shape)
	a_norm = float(np.max(np.abs(exact)))
	for name, which, method in (("lobpcg_la", "LA", "lobpcg"), ("lobpcg_sa", "SA", "lobpcg"), ("trlan_la", "LA", "trlan")):
		kw_m = kw if method == "lobpcg" else {}
		(w, V), counts, _, times = _walls(torch, lambda: ptt.eigsh(op, k=EIG_K, which=which, method=method, seed=17, **kw_m))
		iters = eigen.ITERATIONS[method]
		r = _residuals(torch, op64, w, V)
		w_np = np.sort(w.double().cpu().numpy())
		pos = np.clip(np.searchsorted(exact, w_np), 1, exact.size - 1)
		dist = np.minimum(np.abs(exact[pos] - w_np), np.abs(exact[pos - 1] - w_np))
		ends = exact[-EIG_K:] if which == "LA" else exact[:EIG_K]
		end_err = float(np.max(np.abs(w_np - ends)))
		row = {"phase": "eigsh", "operator": label, "call": name, "n": op.shape[0], "k": EIG_K, **kw_m, "iterations": iters,
			"eigenvalues": w_np.tolist(), "residuals": r.tolist(), "bauer_fike_dist": dist.tolist(),
			"max_err_vs_closed_form_ends": end_err, "ends_held": hold_ends, **_wall_keys(times), "launches": counts}
		emit(row)
		if not np.all(dist <= r + 8 * np.finfo(np.float32).eps * a_norm):
			raise AssertionError(f"eigsh {label} {name}: an eigenvalue lies farther from the spectrum than its residual: {row}")
		if hold_ends and not (end_err <= EIG_END_TOL * a_norm and np.all(r <= EIG_RES_TOL * a_norm)):
			raise AssertionError(f"eigsh {label} {name} missed the closed-form {which} end: {row}")
		if method == "lobpcg" and counts["dia_stencil"] < 1:
			raise AssertionError(f"eigsh {label} {name} did not launch the node-major stencil: {counts}")
		if method == "trlan" and counts["dia_stencil_t"] < 1:
			raise AssertionError(f"eigsh {label} {name} did not launch the probe-major stencil: {counts}")
		_add(total, counts)
		del w, V


def eigensolvers(torch, ptt, dev) -> dict:
	"""Phase 17: ``eigsh`` (LOBPCG LA and SA, thick-restart LA) on phase 10's mesh, each pair held by
	Bauer-Fike to the closed-form spectrum, and on :func:`separated_spectrum`, held to its closed-form
	ends; the node-major stencil at LOBPCG's block widths against its plain version;
	``filtered_eigsh`` on the example's grid Laplacian; ``block_slq_trace`` of the heat kernel;
	``Toeplitz`` against the DIA path Laplacian; ``normalize_unit``."""
	from primate_tpu_torch import eigen
	from primate_tpu_torch.ops import dia

	A = mesh_laplacian(MESH_SIDE)
	mu = mesh_modes(MESH_SIDE)
	exact = np.sort((1.0 + mu[:, None] + mu[None, :]).ravel())
	op = ptt.DIAOperator.from_scipy(A, dtype=torch.float32, device=dev)
	total = {}
	# LOBPCG applies the operator to (n, k + 2) and (n, 3(k + 2)) blocks.
	gen = torch.Generator(device=dev)
	gen.manual_seed(17)
	errs = {}
	for k in (EIG_K + 2, 3 * (EIG_K + 2)):
		V = torch.randn((op.shape[0], k), generator=gen, device=dev)
		errs[f"dia_stencil_{op.shape[0]}x{k}"] = _check_plain(torch, f"dia_stencil at ({op.shape[0]}, {k})",
			dia.dia_stencil(op.bands, op.offsets_t, V), dia.dia_stencil_ref(op.bands, op.offsets_t.cpu(), V))
	emit({"phase": "eig_kernel_checks", "max_rel_err": errs})
	del V
	# The mesh's ends are clustered (its top 8 lie within 1.1e-4): the pairs are held by Bauer-Fike
	# only, and their distance from the closed-form ends is reported.
	_eigsh_calls(torch, ptt, "mesh", op, exact, dict(maxiter=EIG_MAXITER, tol=EIG_TOL), False, total)
	S, sep_exact = separated_spectrum(op.shape[0], EIG_K, seed=17)
	sop = ptt.DIAOperator.from_scipy(S, dtype=torch.float32, device=dev)
	_eigsh_calls(torch, ptt, "separated", sop, sep_exact, dict(maxiter=EIG_SEP_MAXITER, tol=EIG_TOL), True, total)
	del S, sop

	# block SLQ: tr exp(−τL) on (n, b) blocks through the node-major stencil.
	for tau in BK_TAUS:
		est, counts, _, times = _walls(torch, lambda: ptt.block_slq_trace(op, "exp", seed=17, t=-tau, **BK))
		want = float(np.exp(-tau) * np.sum(np.exp(-tau * mu)) ** 2)
		row = {"phase": "block_slq_trace", "tau": tau, **BK, "estimate": est, "exact": want, "rel_err": abs(est - want) / want,
			**_wall_keys(times), "launches": counts}
		emit(row)
		if not row["rel_err"] < 0.02 or counts["dia_stencil"] < 1:
			raise AssertionError(f"block_slq_trace off or not through dia_stencil: {row}")
		_add(total, counts)

	# normalize_unit: the closed-form extremes of the mesh, mapped, lie in [−1, 1].
	S = ptt.normalize_unit(op, seed=17)
	mapped = S.s * (np.array([exact[0], exact[-1]]) + S.t)
	emit({"phase": "normalize_unit", "s": S.s, "t": S.t, "mapped_extremes": mapped.tolist()})
	if not (-1.0 <= mapped.min() and mapped.max() <= 1.0):
		raise AssertionError(f"normalize_unit maps the mesh's spectrum to {mapped}")
	del op, S
	torch.cuda.empty_cache()

	# filtered_eigsh: the lowest FE_COUNT eigenpairs of the grid Laplacian, the window's top edge in a gap.
	G, lam = grid_laplacian(*FE_GRID)
	gop = ptt.DIAOperator.from_scipy(G, dtype=torch.float32, device=dev)
	lo, hi = ptt.operators.gershgorin_interval(gop)
	a, b = 0.0, float(0.5 * (lam[FE_COUNT - 1] + lam[FE_COUNT]))
	deg = int(np.ceil(2.0 * (hi - lo) / (b - a)))  # the window twice the filter's resolution (hi − lo)/deg
	(w, V), counts, _, times = _walls(torch, lambda: ptt.filtered_eigsh(gop, (a, b), k=FE_COUNT, deg=deg, spectral_interval=(lo, hi), seed=17))
	g64 = ptt.DIAOperator(gop.bands.double(), gop.offsets, gop.shape)
	r = _residuals(torch, g64, w, V) if w.numel() else np.zeros(0)
	w_np = w.double().cpu().numpy()
	err = float(np.max(np.abs(w_np - lam[:FE_COUNT]))) if w_np.size == FE_COUNT else float("inf")
	row = {"phase": "filtered_eigsh", "grid": list(FE_GRID), "n": gop.shape[0], "window": [a, b], "deg": deg,
		"spectral_interval": [lo, hi], "found": int(w_np.size), "expected": FE_COUNT, "iterations": eigen.ITERATIONS["filtered_eigsh"],
		"max_err": err, "max_residual": float(r.max()) if r.size else None, **_wall_keys(times), "launches": counts}
	emit(row)
	if not (w_np.size == FE_COUNT and err <= 1e-4 * float(lam[-1])):
		raise AssertionError(f"filtered_eigsh missed the slice: {row}")
	_add(total, counts)
	del gop, g64, w, V

	# Toeplitz(c = [3, −1, 0, …]) is the path Laplacian: its product against the DIA operator's.
	n = PREP_PATH_N
	c = torch.zeros(n, dtype=torch.float32, device=dev)
	c[0], c[1] = 3.0, -1.0
	T = ptt.Toeplitz(c)
	D = ptt.DIAOperator.from_scipy(build_laplacian(n), dtype=torch.float32, device=dev)
	gen = torch.Generator(device=dev)
	gen.manual_seed(17)
	V = torch.randn((TOEPLITZ_PROBES, n), generator=gen, device=dev, dtype=torch.float32).T  # a probe-major block
	YT, _, _, t_times = _walls(torch, lambda: T.matmat(V))
	YD, counts, _, d_times = _walls(torch, lambda: D.matmat(V))
	err = float((YT - YD).abs().max()) / float(YD.abs().max())
	row = {"phase": "toeplitz", "n": n, "probes": TOEPLITZ_PROBES, "rel_err": err, "toeplitz_wall_s_median": statistics.median(t_times),
		"toeplitz_wall_s": t_times, "dia_wall_s_median": statistics.median(d_times), "dia_wall_s": d_times, "dia_launches": counts}
	emit(row)
	if not err <= 1e-4:
		raise AssertionError(f"Toeplitz and the DIA path Laplacian disagree: {row}")
	_add(total, counts)
	return total


def rect_noise(torch, ptt, dev, m: int, n: int, bs: int, tiles_per_block_row: int, seed: int):
	"""A rectangular BSR noise operator (the seeded generator beside ``block_random_spd``):
	``tiles_per_block_row`` random block columns in each of the ``m/bs`` block rows (a repeat
	kept once), N(0, 1) entries scaled so that every column has unit expected norm."""
	rng = np.random.default_rng(seed)
	nbr, nbc = -(-m // bs), -(-n // bs)
	cols = rng.integers(0, nbc, size=(nbr, tiles_per_block_row))
	key = np.unique(np.arange(nbr)[:, None] * nbc + cols)  # sorted: block rows, then block columns
	rows, cols = key // nbc, key % nbc
	nnz = key.size * bs * bs
	blocks = rng.standard_normal((key.size, bs, bs), dtype=np.float32) * np.float32(1.0 / np.sqrt(nnz / n))
	indptr = np.zeros(nbr + 1, np.int64)
	np.cumsum(np.bincount(rows, minlength=nbr), out=indptr[1:])
	return ptt.BSROperator.from_numpy(blocks, cols, indptr, (m, n), dtype=torch.float32, device=dev)


def random_dia(torch, ptt, dev, n: int, offsets, seed: int):
	"""A float32 DIA operator with N(0, 1) bands (not symmetric), each band zero where its column
	falls outside [0, n)."""
	gen = torch.Generator(device=dev)
	gen.manual_seed(seed)
	bands = torch.randn((len(offsets), n), generator=gen, device=dev)
	rows = torch.arange(n, device=dev)
	for d, off in enumerate(offsets):
		bands[d, (rows + off < 0) | (rows + off >= n)] = 0.0
	return ptt.DIAOperator(bands, offsets, (n, n))


def dia_scipy(op):
	"""A DIA operator's matrix as scipy CSR, float64."""
	import scipy.sparse as sps

	n = op.shape[0]
	bands = op.bands.double().cpu().numpy()
	rows, cols, vals = [], [], []
	for d, off in enumerate(op.offsets):
		i = np.arange(max(0, -off), min(n, n - off))
		rows.append(i)
		cols.append(i + off)
		vals.append(bands[d, i])
	return sps.csr_matrix((np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))), shape=(n, n))


def rectangular(torch, ptt, dev) -> tuple:
	"""Phase 18: ``examples/rectangular_spectra.py`` at scale: X = L Rᵀ + σ G (G the BSR noise
	operator), its top singular values by ``svds``, ``rsvd`` and ``lanczos_bidiag``, ‖X‖²_F and the
	nuclear norm by Gram quadrature, and the Gram density; the adjoint applies (G's and a DIA
	operator's) against their plain versions, and the Gram path over that DIA operator. Returns
	the path's launches, X and ‖X‖²_F (phase 19 takes its Schatten norm)."""
	from primate_tpu_torch.ops import _common

	m, n, r, sigma = RECT["m"], RECT["n"], RECT["r"], RECT["sigma"]
	t0 = time.perf_counter()
	G = rect_noise(torch, ptt, dev, m, n, RECT["bs"], RECT["tiles_per_block_row"], RECT["seed"])
	rng = np.random.default_rng(RECT["seed"] + 1)
	L = torch.tensor(rng.standard_normal((m, r)) / np.sqrt(m), dtype=torch.float32, device=dev)
	R = torch.tensor(rng.standard_normal((n, r)) * np.geomspace(20.0, 2.0, r), dtype=torch.float32, device=dev)
	X = ptt.ComposedOperator(L, R.T.contiguous()) + sigma * G
	torch.cuda.synchronize()
	t_build = time.perf_counter() - t0
	# ‖X‖²_F = tr(LᵀL·RᵀR) + 2σ·tr(Lᵀ G R) + σ²‖G‖²_F, each term in float64 from the factors and the tiles.
	L64, R64 = L.double(), R.double()
	G64 = ptt.BSROperator(G.blocks.double(), G.indices, G.indptr, G.shape)
	fro2 = float(torch.trace((L64.T @ L64) @ (R64.T @ R64)) + 2 * sigma * torch.sum(L64 * G64.matmat(R64))
		+ sigma**2 * torch.sum(G64.blocks**2))
	del G64, L64, R64
	emit({"phase": "rect_build", "m": m, "n": n, "tiles": int(G.blocks.shape[0]), "nnz": int(G.nnz), "r": r, "sigma": sigma,
		"seconds": t_build, "fro2_exact": fro2})
	total = {}
	# The adjoint applies at this path's shapes against their plain versions: bsr_spmm on G's
	# transposed tiles (the Gram and svds blocks), the stencils on a DIA operator's adjoint bands.
	gen = torch.Generator(device=dev)
	gen.manual_seed(18)
	errs = {}
	for k in (8, 16):
		U = torch.randn((m, k), generator=gen, device=dev)
		errs[f"bsr_adjoint_{m}x{k}"] = _check_plain(torch, f"G.rmatmat at ({m}, {k})", G.rmatmat(U), G.rmatmat_plain(U))
	del U
	D = random_dia(torch, ptt, dev, MESH_SIDE**2, (-MESH_SIDE, -1, 0, 1, MESH_SIDE), seed=18)
	for k in (8, 16):
		W = torch.randn((k, D.shape[0]), generator=gen, device=dev)
		want = D.rmatmat_plain(W.T)
		errs[f"dia_adjoint_node_major_{D.shape[0]}x{k}"] = _check_plain(torch, f"D.rmatmat node-major ({k})",
			D.rmatmat(W.T.contiguous()), want)
		errs[f"dia_adjoint_probe_major_{k}x{D.shape[0]}"] = _check_plain(torch, f"D.rmatmat_t probe-major ({k})",
			D.rmatmat_t(W), want.T)
	del W, want
	emit({"phase": "adjoint_checks", "max_rel_err": errs})

	# The Gram path over the DIA operator (GKL through D's stencils and its adjoint's):
	# tr((DᵀD)²) = ‖DᵀD‖²_F, exact in Gauss quadrature, against scipy's product.
	Ds = dia_scipy(D)
	gram2 = float(np.sum((Ds.T @ Ds).data ** 2))
	del Ds

	def dia_gram():
		M = ptt.MatrixFunction(ptt.GramOperator(D), lambda x: x * x)
		est, res = ptt.hutch(M, batch=16, converge="count", count=16, seed=18, full=True)
		return est, float(np.sqrt(res.estimator.converged_variance / res.nit))

	(est, sd), counts, _, times = _walls(torch, dia_gram)
	_add(total, counts)
	row = {"phase": "rect", "call": "dia_gram_square", "n": D.shape[0], "estimate": est, "exact": gram2, "sigma": sd,
		"z": (est - gram2) / sd, **_wall_keys(times), "launches": counts}
	emit(row)
	if not (abs(est - gram2) <= 10 * sd and counts["dia_stencil_t"] >= 1):
		raise AssertionError(f"tr((DᵀD)²) by Gram quadrature over DIA more than 10σ off or not through dia_stencil_t: {row}")
	del D

	(U, s, Vh), counts, copies, times = _walls(torch, lambda: ptt.svds(X, k=SVD_K, maxiter=EIG_MAXITER, tol=EIG_TOL, seed=18))
	_add(total, counts)
	row = {"phase": "rect", "call": "svds", "k": SVD_K, "tol": EIG_TOL, "singular_values": s.tolist(), **_wall_keys(times),
		"launches": counts, "layout_copies": copies}
	Vc = Vh.T.contiguous()
	res_v = (torch.linalg.vector_norm(X.matmat(Vc) - U * s[None, :], dim=0) / s).cpu().numpy()
	res_u = (torch.linalg.vector_norm(X.rmatmat(U.contiguous()) - Vc * s[None, :], dim=0) / s).cpu().numpy()
	row.update({"residual_xv": res_v.tolist(), "residual_xtu": res_u.tolist()})
	emit(row)
	(_, s_r, _), counts, copies, times = _walls(torch, lambda: ptt.rsvd(X, k=SVD_K, n_iter=2, seed=18))
	_add(total, counts)
	emit({"phase": "rect", "call": "rsvd", "k": SVD_K, "n_iter": 2, "singular_values": s_r.tolist(), **_wall_keys(times),
		"launches": counts, "layout_copies": copies})
	out, counts, copies, times = _walls(torch, lambda: ptt.lanczos_bidiag(X, deg=BIDIAG_DEG, orth=-1, seed=18))
	_add(total, counts)
	a, b = out.alphas[:, 0].double().cpu().numpy(), out.betas[:, 0].double().cpu().numpy()
	ritz = np.linalg.svd(np.diag(a) + np.diag(b, 1), compute_uv=False)[:SVD_K]
	emit({"phase": "rect", "call": "lanczos_bidiag", "deg": BIDIAG_DEG, "ritz_values": ritz.tolist(), **_wall_keys(times),
		"launches": counts, "layout_copies": copies})
	s_s = np.sort(s.double().cpu().numpy())[::-1]
	s_r = s_r.double().cpu().numpy()
	agree = float(max(np.max(np.abs(s_s - s_r) / s_s), np.max(np.abs(s_s - ritz) / s_s)))
	emit({"phase": "rect", "call": "top_singular_values", "max_rel_disagreement": agree})
	if not (agree <= 1e-4 and np.all(res_v <= 1e-3) and np.all(res_u <= 1e-3)):
		raise AssertionError(f"svds, rsvd and lanczos_bidiag disagree ({agree}) or svds's residuals are high ({res_v}, {res_u})")

	def gram_hutch(fun, transpose_first):
		M = ptt.MatrixFunction(ptt.GramOperator(X, transpose_first=transpose_first), fun)
		est, res = ptt.hutch(M, batch=16, converge="count", count=16, seed=18, full=True)
		return est, float(np.sqrt(res.estimator.converged_variance / res.nit))

	(est, sd), counts, copies, times = _walls(torch, lambda: gram_hutch("identity", True))
	_add(total, counts)
	row = {"phase": "rect", "call": "frobenius", "estimate": est, "exact": fro2, "sigma": sd, "z": (est - fro2) / sd,
		**_wall_keys(times), "launches": counts, "layout_copies": copies}
	emit(row)
	if not abs(est - fro2) <= 10 * sd:
		raise AssertionError(f"‖X‖²_F by Gram quadrature more than 10σ off: {row}")
	nuc = {}
	for tf in (True, False):
		nuc[tf], counts, copies, times = _walls(torch, lambda: gram_hutch("sqrt", tf))
		_add(total, counts)
		emit({"phase": "rect", "call": "nuclear_norm", "transpose_first": tf, "estimate": nuc[tf][0], "sigma": nuc[tf][1],
			**_wall_keys(times), "launches": counts, "layout_copies": copies})
	spread = float(np.hypot(nuc[True][1], nuc[False][1]))
	if not abs(nuc[True][0] - nuc[False][0]) <= NUC_SIGMAS * spread:
		raise AssertionError(f"the two Gram sides' nuclear norms differ by more than {NUC_SIGMAS}σ: {nuc}")
	(ts, phi), counts, copies, times = _walls(torch, lambda: ptt.spectral_density(ptt.GramOperator(X), seed=18))
	_add(total, counts)
	mass = _integral(phi, ts)
	emit({"phase": "rect", "call": "gram_density", "mass": mass, **_wall_keys(times), "launches": counts, "layout_copies": copies})
	if not abs(mass - 1.0) <= 1e-2:
		raise AssertionError(f"the Gram density's mass is {mass}")

	# Both directions through the BSR kernel: X V on the tiles, Xᵀ U on the transposed tiles.
	gen = torch.Generator(device=dev)
	gen.manual_seed(18)
	for label, fn in (("X_V", lambda: X.matmat(torch.randn((n, 8), generator=gen, device=dev))),
		("Xt_U", lambda: X.rmatmat(torch.randn((m, 8), generator=gen, device=dev)))):
		torch.cuda.synchronize()
		_common.reset_launches()
		fn()
		torch.cuda.synchronize()
		if _common.LAUNCHES["bsr_spmm"] != 1:
			raise AssertionError(f"{label} launched bsr_spmm {_common.LAUNCHES['bsr_spmm']} times, expected 1")
	emit({"phase": "rect", "call": "launches", "launches": total, "bsr_both_directions": True})
	return total, X, fro2


# --- Phase 19: the recipes ---


def _rec_call(torch, total: dict, label: str, fn, **row):
	"""One recipe call through :func:`_walls` (the counted call and one timed repeat, or the one run
	over 5 s); its launches are added to ``total``. Returns ``(out, counts, row)``."""
	out, counts, copies, times = _walls(torch, fn, reps=1)
	_add(total, counts)
	return out, counts, {"phase": "recipes", "call": label, **row, **_wall_keys(times), "launches": counts}


def _rec_check(ok: bool, row: dict) -> None:
	emit(row)
	if not ok:
		raise AssertionError(f"recipes: {row['call']} failed its check: {row}")


def _rec_flagship(torch, ptt, dev, total: dict) -> None:
	"""``logdet`` against the flagship composition (bit for bit) and the GP noise sweep by
	``shifted_trace``, on the 10M tridiagonal at ``orth=0``: both step kernels, 20 + 20."""
	rec = ptt.recipes
	op = ptt.DIAOperator.from_scipy(build_laplacian(REC_N), dtype=torch.float32, device=dev)
	kw = dict(deg=DEG, orth=ORTH, batch=PROBES, converge="count", count=PROBES, seed=REC_SEED)
	est, counts, row = _rec_call(torch, total, "logdet_flagship", lambda: rec.logdet(op, **kw), n=REC_N)
	same = ptt.hutch(ptt.MatrixFunction(op, "log", deg=DEG, orth=ORTH), batch=PROBES, converge="count", count=PROBES,
		seed=REC_SEED)
	exact = exact_logdet(REC_N)
	row.update({"estimate": est, "composition": same, "exact": exact, "rel_err": abs(est - exact) / abs(exact)})
	steps = (counts["lanczos_dia_step"], counts["lanczos_dia_residual"])
	_rec_check(est == same and row["rel_err"] < 0.05 and steps == (DEG, DEG), row)

	curve, counts, row = _rec_call(torch, total, "shifted_trace_flagship", lambda: rec.shifted_trace(
		op, "log", shifts=REC_SHIFTS, **kw), n=REC_N, shifts=REC_SHIFTS.tolist())
	lam = 3.0 - 2.0 * np.cos(np.pi * np.arange(1, REC_N + 1) / (REC_N + 1))
	exact = np.array([np.sum(np.log(lam + t)) for t in REC_SHIFTS])
	rel = np.abs(np.asarray(curve) - exact) / np.abs(exact)
	row.update({"estimates": np.asarray(curve).tolist(), "exact": exact.tolist(), "rel_err": rel.tolist()})
	steps = (counts["lanczos_dia_step"], counts["lanczos_dia_residual"])
	_rec_check(bool(np.all(rel < 0.05)) and steps == (DEG, DEG), row)


def _rec_mesh(torch, ptt, dev, total: dict) -> None:
	"""The SLQ recipes at their defaults (``orth=5``: pass A and the CGS window's chain, no pass B),
	the brackets, the bilinear forms and a weighted trace on phase 10's mesh, against closed forms."""
	from primate_tpu_torch.ops import dia

	rec = ptt.recipes
	side = MESH_SIDE
	mu = mesh_modes(side)
	lam = (1.0 + mu[:, None] + mu[None, :]).ravel()
	n = lam.size
	op = ptt.DIAOperator.from_scipy(mesh_laplacian(side), dtype=torch.float32, device=dev)
	# Pass A at this path's shape (32 probes), against its plain version.
	gen = torch.Generator(device=dev)
	gen.manual_seed(REC_SEED)
	q_cur, q_prev = (torch.randn((32, n), generator=gen, device=dev) / np.sqrt(n) for _ in range(2))
	beta = torch.rand(32, generator=gen, device=dev) + 0.5
	v, alpha = dia.lanczos_dia_step(op.bands, op.offsets_t, q_cur, q_prev, beta)
	v_ref, alpha_ref = dia.lanczos_dia_step_ref(op.bands, op.offsets_t.cpu(), q_cur, q_prev, beta)
	errs = {"lanczos_dia_step_v": _check_plain(torch, "pass A at (32, 1M)", v, v_ref),
		"lanczos_dia_step_alpha": _rel_err(torch, alpha, alpha_ref)[1]}
	if not errs["lanczos_dia_step_alpha"] <= ALPHA_TOL["float32"]:
		raise AssertionError(f"pass A's alpha at (32, 1M) is off its plain version: {errs}")
	emit({"phase": "recipes_kernel_checks", "operator": "mesh", "max_rel_err": errs})
	del q_cur, q_prev, v, v_ref

	(est, res), counts, row = _rec_call(torch, total, "logdet_defaults", lambda: rec.logdet(op, seed=REC_SEED, full=True), n=n)
	exact = float(np.sum(np.log(lam)))
	row.update({"estimate": est, "exact": exact, "rel_err": abs(est - exact) / exact, "probes": res.nit})
	batches = res.nit // 32
	_rec_check(row["rel_err"] < 0.01 and counts["lanczos_dia_step"] == 20 * batches and counts["lanczos_dia_residual"] == 0, row)

	res, counts, row = _rec_call(torch, total, "trace_bounds", lambda: rec.trace_bounds(op, "log", nv=32, seed=REC_SEED, full=True))
	lo, hi, sd = res["lower"], res["upper"], res["mc_stderr"]
	row.update({"lower": lo, "upper": hi, "mc_stderr": sd, "rules": res["rules"], "interval": list(res["interval"]), "exact": exact})
	_rec_check(lo <= hi and lo - 4 * sd <= exact <= hi + 4 * sd, row)

	(deg, hist), counts, row = _rec_call(torch, total, "suggest_degree", lambda: rec.suggest_degree(
		op, "log", rtol=1e-3, seed=REC_SEED, full=True))
	gaps = [h["gap"] for h in hist]
	row.update({"degree": deg, "history": hist})
	last = hist[-1]
	stopped = last["gap"] <= 1e-3 * abs(0.5 * (last["lower"] + last["upper"])) or deg == 256
	_rec_check(all(g2 <= g1 for g1, g2 in zip(gaps, gaps[1:])) and stopped, row)

	heat, counts, row = _rec_call(torch, total, "heat_kernel_trace", lambda: rec.heat_kernel_trace(op, t=TAUS, seed=REC_SEED),
		taus=TAUS.tolist())
	exact_h = np.array([np.exp(-t) * np.sum(np.exp(-t * mu)) ** 2 for t in TAUS])
	rel = np.abs(np.asarray(heat) - exact_h) / exact_h
	row.update({"estimates": np.asarray(heat).tolist(), "exact": exact_h.tolist(), "rel_err": rel.tolist()})
	_rec_check(bool(np.all(rel < 0.02)), row)

	eff, counts, row = _rec_call(torch, total, "effective_dim", lambda: rec.effective_dim(op, lam=list(REC_LAMS), seed=REC_SEED),
		lams=list(REC_LAMS))
	exact_e = np.array([np.sum(lam / (lam + x)) for x in REC_LAMS])
	rel = np.abs(np.asarray(eff) - exact_e) / exact_e
	row.update({"estimates": np.asarray(eff).tolist(), "exact": exact_e.tolist(), "rel_err": rel.tolist()})
	_rec_check(bool(np.all(rel < 0.01)), row)

	norms, counts, row = _rec_call(torch, total, "schatten", lambda: rec.schatten(op, p=list(REC_PS), seed=REC_SEED), ps=list(REC_PS))
	exact_s = np.array([np.sum(lam**p) ** (1.0 / p) for p in REC_PS])
	rel = np.abs(np.asarray(norms) - exact_s) / exact_s
	row.update({"estimates": np.asarray(norms).tolist(), "exact": exact_s.tolist(), "rel_err": rel.tolist()})
	_rec_check(bool(np.all(rel < 0.01)), row)

	count, counts, row = _rec_call(torch, total, "eigencount", lambda: rec.eigencount(op, (2.0, 3.0), seed=REC_SEED))
	window = float(rec._memo_fun("window", 2.0, 3.0, 0.02)(torch.from_numpy(lam)).sum())
	row.update({"count": count, "window_exact": window, "hard_count": int(np.sum((lam > 2.0) & (lam <= 3.0))),
		"rel_err": abs(count - window) / window})
	_rec_check(row["rel_err"] < 0.05, row)

	# Entries of exp(−A/2) = e^{−1/2}·E⊗E, E = exp(−T/2) by a dense eigh of T, at seeded node pairs.
	rng = np.random.default_rng(REC_SEED)
	i = rng.integers(side + 2, n - side - 2, REC_PAIRS)
	j = i + rng.choice([1, 2, side - 1, side, side + 1], REC_PAIRS)
	lam_t, Q = np.linalg.eigh(np.diag(2.0 * np.ones(side)) - np.diag(np.ones(side - 1), 1) - np.diag(np.ones(side - 1), -1))
	E = (Q * np.exp(-0.5 * lam_t)) @ Q.T
	want = np.exp(-0.5) * E[i // side, j // side] * E[i % side, j % side]
	U = torch.zeros((n, REC_PAIRS), device=dev)
	V = torch.zeros((n, REC_PAIRS), device=dev)
	U[torch.as_tensor(i, device=dev), torch.arange(REC_PAIRS, device=dev)] = 1.0
	V[torch.as_tensor(j, device=dev), torch.arange(REC_PAIRS, device=dev)] = 1.0
	got, counts, row = _rec_call(torch, total, "bilinear_form", lambda: rec.bilinear_form(op, U, V, fun="exp", fun_kwargs={"t": -0.5}))
	err = float(np.max(np.abs(got - want)))
	row.update({"pairs": [[int(a), int(b)] for a, b in zip(i, j)], "entries": got.tolist(), "exact": want.tolist(), "max_abs_err": err})
	_rec_check(err <= 1e-5, row)
	del U, V

	w = torch.as_tensor(rng.uniform(0.0, 2.0, n), dtype=torch.float32, device=dev)
	(est, res), counts, row = _rec_call(torch, total, "weighted_trace", lambda: rec.weighted_trace(op, w, seed=REC_SEED, full=True))
	exact_w = 5.0 * float(torch.sum(w.double()))
	sd = float(np.sqrt(res.estimator.converged_variance / res.nit))
	row.update({"estimate": est, "exact": exact_w, "sigma": sd, "z": (est - exact_w) / sd})
	_rec_check(abs(est - exact_w) <= 5 * sd, row)

	(nv, info), counts, row = _rec_call(torch, total, "suggest_probes", lambda: rec.suggest_probes(op, "log", eps=1e-3, seed=REC_SEED,
		full=True))
	row.update({"nv": nv, "pilot": info["pilot"], "estimate": info["estimate"], "variance": info["variance"]})
	_rec_check(nv >= info["pilot"], row)


def _rec_separated(torch, ptt, dev, total: dict) -> None:
	"""The eigenspace and solve recipes on :func:`separated_spectrum` (phase 17's; 1M rows, 7
	diagonals): ``slogdet`` of a shifted copy with 3 negative eigenvalues, ``condition_number``,
	``deflated_trace``, ``topk``, ``trace_inv`` by SLQ and by Jacobi-preconditioned CG, and
	``tikhonov`` on 64 right-hand sides, against the closed-form spectrum."""
	from primate_tpu_torch.ops import dia

	rec = ptt.recipes
	S, ew = separated_spectrum(MESH_SIDE**2, EIG_K, seed=17)
	op = ptt.DIAOperator.from_scipy(S, dtype=torch.float32, device=dev)
	op64 = ptt.DIAOperator(op.bands.double(), op.offsets, op.shape)
	n = op.shape[0]
	eig_kw = dict(tol=EIG_TOL, maxiter=EIG_SEP_MAXITER)
	# The stencils at this path's shapes (CG's 64 and 32 probe blocks, LOBPCG's k + 2 columns).
	gen = torch.Generator(device=dev)
	gen.manual_seed(REC_SEED)
	offs = op.offsets_t.cpu()
	errs = {}
	for k in (REC_RHS, 32):
		x = torch.randn((k, n), generator=gen, device=dev)
		errs[f"dia_stencil_t_{k}x{n}"] = _check_plain(torch, f"dia_stencil_t at ({k}, {n})", dia.dia_stencil_t(op.bands, op.offsets_t, x),
			dia.dia_stencil_t_ref(op.bands, offs, x))
	x = torch.randn((n, EIG_K + 2), generator=gen, device=dev)
	errs[f"dia_stencil_{n}x{EIG_K + 2}"] = _check_plain(torch, f"dia_stencil at ({n}, {EIG_K + 2})", dia.dia_stencil(op.bands, op.offsets_t, x),
		dia.dia_stencil_ref(op.bands, offs, x))
	emit({"phase": "recipes_kernel_checks", "operator": "separated", "max_rel_err": errs})
	del x

	shifted = op + REC_SHIFT
	((sign, logabs), res), counts, row = _rec_call(torch, total, "slogdet", lambda: rec.slogdet(
		shifted, batch=64, converge="count", count=512, seed=REC_SEED, full=True), shift=REC_SHIFT)
	exact = float(np.sum(np.log(np.abs(ew + REC_SHIFT))))
	row.update({"sign": sign, "n_negative": res.info["n_negative"], "logabsdet": logabs, "exact": exact,
		"rel_err": abs(logabs - exact) / abs(exact)})
	_rec_check(sign == -1.0 and res.info["n_negative"] == 3 and row["rel_err"] < 0.01, row)

	kappa, counts, row = _rec_call(torch, total, "condition_number", lambda: rec.condition_number(op, seed=REC_SEED, **eig_kw))
	row.update({"kappa": kappa, "exact": ew[-1] / ew[0], "rel_err": abs(kappa - ew[-1] / ew[0]) / (ew[-1] / ew[0])})
	_rec_check(row["rel_err"] <= 1e-4 and counts["dia_stencil"] >= 1, row)

	est, counts, row = _rec_call(torch, total, "deflated_trace", lambda: rec.deflated_trace(op, "log", k=EIG_K, which="LA",
		seed=REC_SEED, eigsh_kwargs=eig_kw))
	exact = float(np.sum(np.log(ew)))
	row.update({"estimate": est, "exact": exact, "rel_err": abs(est - exact) / abs(exact)})
	_rec_check(row["rel_err"] < 0.005 and counts["dia_stencil"] >= 1, row)

	(P, w, Vk), counts, row = _rec_call(torch, total, "topk", lambda: rec.topk(op, k=EIG_K, which="LA", return_eigenvectors=True,
		seed=REC_SEED, **eig_kw))
	top = np.sort(10.0 - 0.25 * np.arange(EIG_K))
	w_err = float(np.max(np.abs(np.sort(w.double().cpu().numpy()) - top)))
	proj_err = float(torch.linalg.matrix_norm(P.matmat(Vk) - Vk))
	row.update({"eigenvalues": np.sort(w.double().cpu().numpy()).tolist(), "max_err": w_err, "projector_err": proj_err})
	_rec_check(w_err <= 1e-4 and proj_err <= 1e-4, row)
	del P, Vk

	exact = float(np.sum(1.0 / ew))
	for label, kw in (("trace_inv_slq", {}), ("trace_inv_cg_jacobi", dict(method="cg", precond="jacobi", rtol=REC_RTOL))):
		est, counts, row = _rec_call(torch, total, label, lambda: rec.trace_inv(op, seed=REC_SEED, **kw))
		row.update({"estimate": est, "exact": exact, "rel_err": abs(est - exact) / exact})
		need = "dia_stencil_t" if kw else "lanczos_dia_step"
		_rec_check(row["rel_err"] < 0.01 and counts[need] >= 1, row)

	B = torch.randn((REC_RHS, n), generator=gen, device=dev).T  # probe-major right-hand sides
	(X, it, _), counts, row = _rec_call(torch, total, "tikhonov", lambda: rec.tikhonov(op, B, lam=0.5, rtol=REC_RTOL, full=True),
		rhs=REC_RHS, rtol=REC_RTOL)
	X64, B64 = X.double(), B.double()
	rel = (torch.linalg.vector_norm(B64 - op64.matmat(X64.contiguous()) - 0.5 * X64, dim=0)
		/ torch.linalg.vector_norm(B64, dim=0)).cpu().numpy()
	row.update({"iterations": int(it), "max_rel_residual": float(rel.max())})
	_rec_check(bool(np.all(rel <= 2 * REC_RTOL)) and counts["dia_stencil_t"] == int(it), row)


def _rec_graph(torch, ptt, dev, total: dict) -> None:
	"""``pagerank`` on phase 9's graph: its symmetric normalised adjacency as CSR (cuSPARSE), the
	uniform personalisation and a seeded block of 8, each residual checked in float64."""
	import scipy.sparse as sps

	L = _powerlaw(PL_N)
	W = (sps.diags(L.diagonal()) - L).tocsr()
	W.eliminate_zeros()
	d = np.asarray(W.sum(axis=1)).ravel()
	dinv = sps.diags(1.0 / np.sqrt(np.where(d > 0, d, 1.0)))
	A64 = (dinv @ W @ dinv).tocsr()
	op = ptt.CSROperator.from_scipy(A64, dtype=torch.float32, device=dev)
	alpha = 0.85
	rng = np.random.default_rng(REC_SEED)
	for label, v in (("pagerank_uniform", None), ("pagerank_block", rng.uniform(0.0, 1.0, (PL_N, REC_BLOCK)))):
		vt = None if v is None else torch.as_tensor(v, dtype=torch.float32, device=dev)
		x, counts, row = _rec_call(torch, total, label, lambda: ptt.recipes.pagerank(op, alpha=alpha, v=vt, rtol=REC_RTOL),
			n=PL_N, nnz=int(A64.nnz))
		x64 = x.double().cpu().numpy()
		v64 = np.full(PL_N, 1.0 / PL_N) if v is None else np.asarray(vt.double().cpu())
		r = (x64 - alpha * (A64 @ x64)) / (1.0 - alpha) - v64
		rel = np.linalg.norm(r, axis=0) / np.linalg.norm(v64, axis=0)
		row.update({"max_rel_residual": float(np.max(rel))})
		_rec_check(bool(np.all(rel <= 2 * REC_RTOL)), row)


def recipes_phase(torch, ptt, dev, X, fro2: float) -> dict:
	"""Phase 19: the recipes at full width, each call timed and its launches counted, against closed
	forms: on the 10M tridiagonal, phase 10's mesh, ``separated_spectrum``, phase 9's graph, phase
	18's X (its Schatten-2 norm through the Gram operator) and phase 17's grid (``filtered_eigsh``
	with no ``k``). Returns the launches of the whole phase."""
	from primate_tpu_torch import eigen

	total = {}
	_rec_flagship(torch, ptt, dev, total)
	torch.cuda.empty_cache()
	_rec_mesh(torch, ptt, dev, total)
	torch.cuda.empty_cache()
	_rec_separated(torch, ptt, dev, total)
	torch.cuda.empty_cache()
	_rec_graph(torch, ptt, dev, total)
	torch.cuda.empty_cache()

	(s2, res), counts, row = _rec_call(torch, total, "schatten_gram", lambda: ptt.recipes.schatten(
		X, p=2, gram=True, batch=16, converge="count", count=16, seed=REC_SEED, full=True))
	sd = float(np.sqrt(res.estimator.converged_variance / res.nit))
	row.update({"norm": s2, "norm_squared": s2**2, "exact": fro2, "sigma": sd, "z": (s2**2 - fro2) / sd})
	_rec_check(abs(s2**2 - fro2) <= 10 * sd and counts["bsr_spmm"] >= 2 * 20, row)

	# filtered_eigsh with no k: the slice counted by recipes.eigencount at its defaults.
	G, lam = grid_laplacian(*FE_GRID)
	gop = ptt.DIAOperator.from_scipy(G, dtype=torch.float32, device=dev)
	lo, hi = ptt.operators.gershgorin_interval(gop)
	a, b = 0.0, float(0.5 * (lam[FE_COUNT - 1] + lam[FE_COUNT]))
	deg = int(np.ceil(2.0 * (hi - lo) / (b - a)))
	count = ptt.recipes.eigencount(gop, (max(a, lo), b), seed=REC_SEED)
	window = float(ptt.recipes._memo_fun("window", max(a, lo), b, 0.02 * (b - max(a, lo)))(torch.from_numpy(lam)).sum())
	(w, V), counts, row = _rec_call(torch, total, "filtered_eigsh_uncounted", lambda: ptt.filtered_eigsh(
		gop, (a, b), deg=deg, spectral_interval=(lo, hi), seed=REC_SEED), grid=list(FE_GRID), window=[a, b], deg=deg)
	w_np = np.sort(w.double().cpu().numpy())
	inside = lam[(lam > a) & (lam <= b)]
	err = float(np.max(np.abs(w_np - inside))) if w_np.size == inside.size else float("inf")
	row.update({"eigencount": count, "window_exact": window, "closed_form_count": int(inside.size), "found": int(w_np.size),
		"max_err": err, "iterations": eigen.ITERATIONS["filtered_eigsh"]})
	_rec_check(w_np.size == inside.size and err <= 1e-4 * float(lam[-1]) and counts["dia_stencil_t"] >= 1, row)

	emit({"phase": "recipes", "call": "launches", "launches": total})
	for k in KERNELS:
		if k not in SHARDED_ONLY + BF16_ONLY and total.get(k, 0) < 1:
			raise AssertionError(f"{k} launched no time in phase 19: {total}")
	return total


def _grad_call(torch, fn) -> tuple:
	"""``fn()`` (a scalar) and its backward, each synced and timed, with the kernel launches of each
	and the peak memory of the pair. Returns ``(value, forward launches, backward launches, row)``."""
	from primate_tpu_torch.ops import _common

	torch.cuda.synchronize()
	torch.cuda.empty_cache()
	torch.cuda.reset_peak_memory_stats()
	_common.reset_launches()
	t0 = time.perf_counter()
	val = fn()
	torch.cuda.synchronize()
	t_fwd = time.perf_counter() - t0
	fwd = dict(_common.LAUNCHES)
	_common.reset_launches()
	t0 = time.perf_counter()
	val.backward()
	torch.cuda.synchronize()
	t_bwd = time.perf_counter() - t0
	bwd = dict(_common.LAUNCHES)
	row = {"forward_s": t_fwd, "backward_s": t_bwd, "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
		"forward_launches": fwd, "backward_launches": bwd}
	return float(val.detach()), fwd, bwd, row


def _fd64(torch, f, x64, D64) -> float:
	"""Central difference ``(f(x + hD) − f(x − hD)) / 2h`` in float64, no gradient."""
	with torch.no_grad():
		return (float(f(x64 + GRAD_H * D64)) - float(f(x64 - GRAD_H * D64))) / (2 * GRAD_H)


def lanczos_grad(torch, ptt, dev) -> dict:
	"""Phase 20: reverse mode through the Lanczos recurrence at full width, on phase 10's mesh
	(n = 1,000,000, 5 diagonals, float32): the gradient with respect to the bands of
	``F = Σ W∘MatrixFunction(L, exp(−x), deg=20, orth=0).matmat(V)`` (64 probes; two-pass by the
	1 GiB rule) and of ``Σ diag(MatrixFunction(L, "log"), differentiable=True)`` (4 × 16 probes); F
	again at ``orth=5`` on 16 probes; each directional derivative along a seeded direction against a
	float64 central difference, and F's float32 gradient against its float64 one. The sweeps run
	``dia_stencil_t`` forward and on the adjoint bands backward, never a step kernel. Then the same on
	a BSR operator (``bsr_spmm`` on the tiles forward, on the transposed tiles backward). Returns the
	kernels' ``grad_launches``."""
	from primate_tpu_torch.diagonal import diag_ratio
	from primate_tpu_torch.trace import probe_sampler

	A = mesh_laplacian(MESH_SIDE)
	base = ptt.DIAOperator.from_scipy(A, dtype=torch.float32, device=dev)
	offsets, n = base.offsets, A.shape[0]
	bands32 = base.bands
	gen = torch.Generator(device=dev)
	gen.manual_seed(GRAD["seed"])
	V = torch.randn((n, GRAD["probes"]), generator=gen, device=dev, dtype=torch.float32)
	W = torch.randn((n, GRAD["probes"]), generator=gen, device=dev, dtype=torch.float32)
	D = torch.randn(bands32.shape, generator=gen, device=dev, dtype=torch.float64)
	D = D / D.abs().max()
	deg = GRAD["deg"]

	def F(bands, orth=0, k=GRAD["probes"]):
		op = ptt.DIAOperator(bands, offsets, (n, n))
		dt = bands.dtype
		Y = ptt.MatrixFunction(op, "exp", t=-1.0, deg=deg, orth=orth).matmat(V[:, :k].to(dt))
		return torch.sum(W[:, :k].to(dt) * Y)

	total = {"forward": {}, "backward": {}}
	out = {}
	rows = {}
	for label, k, orth in (("matmat_orth0", GRAD["probes"], 0), ("matmat_orth5", GRAD["orth5_probes"], 5)):
		b = bands32.clone().requires_grad_(True)
		val, fwd, bwd, row = _grad_call(torch, lambda: F(b, orth, k))
		g32 = b.grad.double()
		dd32 = float(torch.sum(g32 * D))
		fd = _fd64(torch, lambda x: F(x, orth, k), bands32.double(), D)
		row.update({"phase": "lanczos_grad", "call": label, "n": n, "probes": k, "deg": deg, "orth": orth, "value": val,
			"directional_derivative": dd32, "central_difference_f64": fd, "h": GRAD_H, "dd_rel_err": abs(dd32 - fd) / abs(fd),
			"tol": GRAD_DD_TOL, "two_pass": ptt.MatrixFunction(base, "exp", deg=deg)._use_two_pass(k)})
		if orth == 0:
			# The float64 gradient of the same F, in two chunks of 32 probes (F is a sum over probes).
			g64 = torch.zeros_like(g32)
			for c0 in range(0, k, k // 2):
				b64 = bands32.double().requires_grad_(True)
				op64 = ptt.DIAOperator(b64, offsets, (n, n))
				Y = ptt.MatrixFunction(op64, "exp", t=-1.0, deg=deg, orth=0).matmat(V[:, c0 : c0 + k // 2].double())
				torch.sum(W[:, c0 : c0 + k // 2].double() * Y).backward()
				g64 += b64.grad
				del b64, op64, Y
				torch.cuda.empty_cache()
			err = float((g32 - g64).abs().max() / g64.abs().max())
			dd64 = float(torch.sum(g64 * D))
			row.update({"grad_f32_vs_f64_rel_err": err, "f64_tol": GRAD_F64_TOL, "directional_derivative_f64": dd64,
				"dd64_rel_err": abs(dd64 - fd) / abs(fd)})
			if not err <= GRAD_F64_TOL:
				raise AssertionError(f"float32 and float64 gradients of F disagree: {row}")
			del g64
		emit(row)
		rows[label] = row
		if not (np.isfinite(dd32) and row["dd_rel_err"] <= GRAD_DD_TOL):
			raise AssertionError(f"{label}: directional derivative off the central difference: {row}")
		if fwd["lanczos_dia_step"] + fwd["lanczos_dia_residual"] + bwd["lanczos_dia_step"] + bwd["lanczos_dia_residual"]:
			raise AssertionError(f"{label}: a differentiated sweep launched a step kernel: {fwd} {bwd}")
		# Each sweep applies dia_stencil_t deg times forward; backward, every apply but the start
		# block's (which needs no gradient), and in the second of two passes not the last either
		# (its α and β are not used: the second pass only accumulates Σ c_t q_t).
		sweeps = 2 if row["two_pass"] else 1
		want = (sweeps * deg, deg - 1 + (deg - 2 if row["two_pass"] else 0))
		if (fwd["dia_stencil_t"], bwd["dia_stencil_t"]) != want:
			raise AssertionError(f"{label}: dia_stencil_t {fwd['dia_stencil_t']} / {bwd['dia_stencil_t']}, expected {want}")
		_add(total["forward"], fwd)
		_add(total["backward"], bwd)
		del b, g32
		torch.cuda.empty_cache()

	# diag(MatrixFunction, differentiable=True): the public call, then the same probes through
	# diag_ratio for the float64 central difference.
	count, batch = GRAD["diag_count"], GRAD["diag_batch"]
	b = bands32.clone().requires_grad_(True)
	seed = GRAD["seed"] + 1
	w = torch.randn(n, generator=gen, device=dev, dtype=torch.float64)

	def G_public():
		M = ptt.MatrixFunction(ptt.DIAOperator(b, offsets, (n, n)), "log", deg=deg, orth=0)
		d = ptt.diag(M, differentiable=True, converge="count", count=count, batch=batch, seed=seed)
		return torch.sum(d.double() * w)

	val, fwd, bwd, row = _grad_call(torch, G_public)
	M32 = ptt.MatrixFunction(base, "log", deg=deg, orth=0)
	draw = probe_sampler(M32, seed, "rademacher")

	def G(x):
		M = ptt.MatrixFunction(ptt.DIAOperator(x, offsets, (n, n)), "log", deg=deg, orth=0)
		return torch.sum(diag_ratio(M, lambda i: draw(i, batch).to(x.dtype), count).double() * w)

	with torch.no_grad():
		same = float(G(bands32))
	dd32 = float(torch.sum(b.grad.double() * D))
	fd = _fd64(torch, G, bands32.double(), D)
	row.update({"phase": "lanczos_grad", "call": "diag_differentiable", "n": n, "probes": count * batch, "deg": deg, "value": val,
		"value_no_grad_sweep": same, "directional_derivative": dd32, "central_difference_f64": fd, "h": GRAD_H,
		"dd_rel_err": abs(dd32 - fd) / abs(fd), "tol": GRAD_DD_TOL})
	emit(row)
	rows["diag"] = row
	if not (abs(same - val) <= 1e-5 * abs(val) and row["dd_rel_err"] <= GRAD_DD_TOL):
		raise AssertionError(f"diag(differentiable=True): {row}")
	_add(total["forward"], fwd)
	_add(total["backward"], bwd)
	del b, w
	torch.cuda.empty_cache()

	# A BSR operator: the tiles' gradient through bsr_spmm's Function, forward and adjoint.
	S = _bsr_cell(**GRAD_BSR)
	bop = ptt.BSROperator.from_scipy(S, blocksize=(GRAD_BSR["bs"], GRAD_BSR["bs"]), dtype=torch.float32, device=dev)
	nb = S.shape[0]
	Vb = torch.randn((nb, 16), generator=gen, device=dev, dtype=torch.float32)
	Wb = torch.randn((nb, 16), generator=gen, device=dev, dtype=torch.float32)
	Db = torch.randn(bop.blocks.shape, generator=gen, device=dev, dtype=torch.float64)
	Db = Db / Db.abs().max()

	def Fb(blocks, deg_b=12):
		op = ptt.BSROperator(blocks, bop.indices, bop.indptr, bop.shape)
		Y = ptt.MatrixFunction(op, "log", deg=deg_b, orth=0).matmat(Vb.to(blocks.dtype))
		return torch.sum(Wb.to(blocks.dtype) * Y)

	t = bop.blocks.clone().requires_grad_(True)
	val, fwd, bwd, row = _grad_call(torch, lambda: Fb(t))
	dd32 = float(torch.sum(t.grad.double() * Db))
	fd = _fd64(torch, Fb, bop.blocks.double(), Db)
	row.update({"phase": "lanczos_grad", "call": "bsr_matmat", "n": nb, "tiles": int(bop.blocks.shape[0]), "probes": 16, "deg": 12,
		"value": val, "directional_derivative": dd32, "central_difference_f64": fd, "h": GRAD_H, "dd_rel_err": abs(dd32 - fd) / abs(fd),
		"tol": GRAD_DD_TOL})
	emit(row)
	rows["bsr"] = row
	if not row["dd_rel_err"] <= GRAD_DD_TOL:
		raise AssertionError(f"BSR sweep: directional derivative off the central difference: {row}")
	if fwd["bsr_spmm"] != 12 or bwd["bsr_spmm"] != 11:
		raise AssertionError(f"BSR sweep: bsr_spmm {fwd['bsr_spmm']} forward, {bwd['bsr_spmm']} backward, expected 12 and 11")
	_add(total["forward"], fwd)
	_add(total["backward"], bwd)
	del t, bop, Vb, Wb, Db
	torch.cuda.empty_cache()
	emit({"phase": "lanczos_grad", "call": "launches", **total})
	return {k: {"grad_launches": {"forward": total["forward"].get(k, 0), "backward": total["backward"].get(k, 0)}}
		for k in ("dia_stencil_t", "bsr_spmm")}


def _complex_bsr_op(torch, ptt, dev):
	"""Phase 21's operator ``H = A + i·s(B − Bᵀ)`` on phase 7's cell, complex64: ``(H, A as scipy, the
	generator that drew B, to go on drawing from)``."""
	from primate_tpu_torch.ops.autograd import bsr_adjoint

	S = _bsr_cell(**BSR_CELL)
	A = ptt.BSROperator.from_scipy(S, blocksize=(BSR_CELL["bs"], BSR_CELL["bs"]), dtype=torch.float32, device=dev)
	gen = torch.Generator(device=dev)
	gen.manual_seed(CBSR_SEED)
	B = torch.randn(A.blocks.shape, generator=gen, device=dev, dtype=torch.float32)
	Bt, indptr_t, indices_t = bsr_adjoint(B, A.indptr, A.indices, A.shape[0])
	if not (torch.equal(indptr_t, A.indptr) and torch.equal(indices_t, A.indices)):
		raise AssertionError("the cell's block pattern is not symmetric")
	return ptt.BSROperator(torch.complex(A.blocks, CBSR_S * (B - Bt)), A.indices, A.indptr, A.shape), S, gen


def complex_bsr(torch, ptt, dev, reps: int = 10) -> dict:
	"""Phase 21: the complex ``bsr_spmm`` at the BSR cell's scale. ``H = A + i·s(B − Bᵀ)`` on phase
	7's matrix A (``block_random_spd``, 1,333,628 8×8 tiles) with B a seeded real block operator on
	A's pattern, complex64: Hutchinson (phase probes) within 5σ of tr H = tr A, and phase 7's calls
	(Hutch++, XTrace, XNysTrace within 1e-3, XDiag finite) through the complex kernel; the adjoint
	against the conjugate transpose; the kernel against its plain version at k = 64 and 240, timed
	beside its bound, its plain version and the library call, and complex128 at a small shape whose V fits in L2
	(``block_random_spd(CBSR_C128_N)``, k = 64: the same numbers, the L2 path's launch, host and device time a call
	split by :func:`launch_times`, the share of the least bound, and complex64 at the same shape beside it)."""
	from primate_tpu_torch.ops import _common
	from primate_tpu_torch.ops import bsr

	op, S, gen = _complex_bsr_op(torch, ptt, dev)
	n = op.shape[0]
	tr = float(S.diagonal().astype(np.float64).sum())
	diag_s = S.diagonal().astype(np.float64)
	emit({"phase": "complex_bsr_build", "n": n, "tiles": int(op.blocks.shape[0]), "nnz": op.nnz, "s": CBSR_S,
		"tile_bytes": op.blocks.numel() * op.blocks.element_size(), "trace": tr})

	# The adjoint: rmatmat against matmat (H is Hermitian) and ⟨U, H V⟩ = ⟨Hᴴ U, V⟩.
	U = torch.randn((n, 8), generator=gen, device=dev, dtype=torch.complex64)
	X = torch.randn((n, 8), generator=gen, device=dev, dtype=torch.complex64)
	HX, HhU = op.matmat(X), op.rmatmat(U)
	lhs, rhs = torch.sum(U.conj() * HX).to(torch.complex128), torch.sum(HhU.conj() * X).to(torch.complex128)
	herm = float((op.rmatmat(X) - HX).abs().max() / HX.abs().max())
	plain = float((HhU - op.rmatmat_plain(U)).abs().max() / HhU.abs().max())
	adj = {"phase": "complex_bsr_adjoint", "inner_product_rel_err": float(abs(lhs - rhs) / abs(lhs)),
		"hermitian_rel_err": herm, "rmatmat_vs_plain_rel_err": plain, "tol": CPLX_TOL["complex64"] * 10}
	emit(adj)
	if not (adj["inner_product_rel_err"] <= 1e-5 and herm <= 1e-5 and plain <= adj["tol"]):
		raise AssertionError(f"complex BSR adjoint: {adj}")
	del U, X, HX, HhU

	calls = {
		"hutch": lambda: ptt.hutch(op, batch=64, pdf="phase", converge="count", count=256, seed=CBSR_SEED, full=True),
		"hutchpp": lambda: ptt.hutchpp(op, m=240, seed=CBSR_SEED),
		"xtrace": lambda: ptt.xtrace(op, batch=64, converge="count", count=256, seed=CBSR_SEED),
		"xnystrace": lambda: ptt.xnystrace(op, m=720, seed=CBSR_SEED),
		"xdiag": lambda: ptt.xdiag(op, m=256, seed=CBSR_SEED),
	}
	launches = 0
	for name, fn in calls.items():
		est, counts, copies, times, peak = _timed_calls(torch, fn)
		row = {"phase": "complex_bsr", "call": name, "wall_s_median": statistics.median(times), "wall_s": times,
			"max_memory_allocated_bytes": peak, "launches": counts, "layout_copies": copies}
		if name == "xdiag":
			row["diag_rel_l2_err"] = float(np.linalg.norm(est - diag_s) / np.linalg.norm(diag_s))
			ok = bool(np.all(np.isfinite(est))) and est.shape == diag_s.shape
		elif name == "hutch":
			est, res = est
			sd = float(np.sqrt(res.estimator.converged_variance / res.nit))
			row.update({"estimate": est, "exact": tr, "sigma": sd, "z": (est - tr) / sd, "rel_err": abs(est - tr) / tr})
			ok = abs(est - tr) <= 5 * sd
		else:
			row.update({"estimate": est, "exact": tr, "rel_err": abs(est - tr) / tr})
			ok = row["rel_err"] < TRACE_TOL
		emit(row)
		if not ok:
			raise AssertionError(f"{name} on the complex BSR cell is off: {row}")
		if counts["bsr_spmm"] < 1:
			raise AssertionError(f"{name} launched no bsr_spmm on the complex cell: {counts}")
		launches += counts["bsr_spmm"]

	out = {"c64_launches": launches}
	B_lib = torch.sparse_bsr_tensor(op.indptr, op.indices, op.blocks, size=op.pshape)
	for k in (64, 240):
		V = torch.randn((n, k), generator=gen, device=dev, dtype=torch.complex64)
		args = (op.blocks, op.indptr, op.indices, V, n)
		got, want = bsr.bsr_spmm(*args), bsr.bsr_spmm_ref(*args)
		torch.cuda.synchronize()
		err, rel = _rel_err(torch, got, want)
		ms, plain_ms = _timed_pair(torch, lambda: bsr.bsr_spmm(*args), lambda: bsr.bsr_spmm_ref(*args), reps)
		b_ms, b_by = bound((op.blocks.numel() + 2 * n * k) * 8, 8 * op.nnz * k)
		lib_ms, lib_note = library_ms(torch, lambda: B_lib @ V, want, reps)  # complex cuSPARSE BSR
		row = {"phase": "complex_bsr_kernel_check", "kernel": "bsr_spmm", "shape": "cell", "k": k, "dtype": "complex64",
			"max_abs_err": err, "rel_err": rel, "tol": CBSR_TOL, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
			"bound_by": b_by, "library_ms": lib_ms, "library_rel_err_or_error": lib_note}
		emit(row)
		if not rel <= CBSR_TOL:
			raise AssertionError(f"complex64 bsr_spmm disagrees with its plain version: {row}")
		g = _bsr_traffic(op, k, 8, ms, b_ms, "complex64")
		if k == 64:
			out.update({f"c64_{key}": row[key] for key in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")})
			out.update({f"c64_{key}": v for key, v in g.items()})
		else:
			out.update({f"c64_k240_{key}": row[key] for key in ("ms", "plain_ms", "bound_ms", "library_ms")})
		del V, got, want
	del B_lib
	# complex128 at a small shape: block_random_spd(8192) with seeded imaginary tiles.
	Ss = _bsr_cell(n=CBSR_C128_N, bs=8, density=0.01, seed=CBSR_SEED)
	As = ptt.BSROperator.from_scipy(Ss, blocksize=(8, 8), dtype=torch.float64, device=dev)
	blocks = torch.complex(As.blocks, torch.randn(As.blocks.shape, generator=gen, device=dev, dtype=torch.float64))
	V = torch.randn((CBSR_C128_N, 64), generator=gen, device=dev, dtype=torch.complex128)
	args = (blocks, As.indptr, As.indices, V, CBSR_C128_N)
	l2_before = _common.L2_LAUNCHES["bsr_spmm"]
	got, want = bsr.bsr_spmm(*args), bsr.bsr_spmm_ref(*args)
	torch.cuda.synchronize()
	l2_path = _common.L2_LAUNCHES["bsr_spmm"] - l2_before
	err, rel = _rel_err(torch, got, want)
	ms, plain_ms = _timed_pair(torch, lambda: bsr.bsr_spmm(*args), lambda: bsr.bsr_spmm_ref(*args), reps)
	b_ms, b_by = bound((blocks.numel() + 2 * CBSR_C128_N * 64) * 16, 8 * blocks.numel() * 64, FP64_FLOP_PER_S)
	split = launch_times(torch, lambda: bsr.bsr_spmm(*args), 100)
	B_lib = torch.sparse_bsr_tensor(As.indptr, As.indices, blocks, size=As.pshape)
	lib_ms, lib_note = library_ms(torch, lambda: B_lib @ V, want, reps)  # complex128 cuSPARSE BSR
	row = {"phase": "complex_bsr_kernel_check", "kernel": "bsr_spmm", "shape": f"block_random_spd({CBSR_C128_N})", "k": 64,
		"dtype": "complex128", "tiles": int(blocks.shape[0]), "v_bytes": V.numel() * 16, "l2_path_launches": l2_path,
		"max_abs_err": err, "rel_err": rel, "tol": CPLX_TOL["complex128"], "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
		"bound_by": b_by, "share_of_bound": b_ms / ms, "host_ms": split["host_ms"], "device_ms": split["device_ms"],
		"share_of_bound_device": b_ms / split["device_ms"], "library_ms": lib_ms, "library_rel_err_or_error": lib_note}
	# complex64 at the same shape (the ring kernel), the same numbers.
	args64 = (blocks.to(torch.complex64), As.indptr, As.indices, V.to(torch.complex64), CBSR_C128_N)
	got64, want64 = bsr.bsr_spmm(*args64), bsr.bsr_spmm_ref(*args64)
	torch.cuda.synchronize()
	rel64 = _rel_err(torch, got64, want64)[1]
	ms64, plain64 = _timed_pair(torch, lambda: bsr.bsr_spmm(*args64), lambda: bsr.bsr_spmm_ref(*args64), reps)
	b64, b64_by = bound((blocks.numel() + 2 * CBSR_C128_N * 64) * 8, 8 * blocks.numel() * 64)
	split64 = launch_times(torch, lambda: bsr.bsr_spmm(*args64), 100)
	row["complex64"] = {"rel_err": rel64, "ms": ms64, "plain_ms": plain64, "bound_ms": b64, "bound_by": b64_by, "share_of_bound": b64 / ms64,
		"host_ms": split64["host_ms"], "device_ms": split64["device_ms"]}
	emit(row)
	if not (rel <= CPLX_TOL["complex128"] and rel64 <= CPLX_TOL["complex64"] and l2_path == 1):
		raise AssertionError(f"complex128 bsr_spmm disagrees with its plain version or skipped its L2 path: {row}")
	out.update({f"c128_{key}": row[key] for key in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "share_of_bound",
		"host_ms", "device_ms", "share_of_bound_device", "l2_path_launches")})
	out.update({f"c128_{key}": v for key, v in _bsr_traffic(As, 64, 16, ms, b_ms, "complex128").items()})
	out.update({f"c64_small_{key}": v for key, v in row["complex64"].items()})
	return {"bsr_spmm": out}


def _draw32(ptt, pdf: str):
	"""A probe sampler ``(generator, shape, dtype)`` that draws ``pdf`` in single precision (complex64 for
	``"phase"``, float32 else) whatever the operator's dtype: a complex64 call and a complex128 call on the
	same seed then take the same probes, those the complex64 call draws with ``pdf`` itself."""
	import torch

	def draw(g, shape, dtype):
		return ptt.sample_isotropic(g, shape, pdf=pdf, dtype=torch.complex64 if pdf == "phase" else torch.float32)

	return draw


def _grad_of(torch, fn, leaf) -> dict:
	"""One differentiable call ``fn()`` and its gradient to ``leaf``: each pass's launches counted from 0,
	its synced wall, and the peak memory of the two."""
	from primate_tpu_torch.ops import _common

	torch.cuda.synchronize()
	torch.cuda.reset_peak_memory_stats()
	_common.reset_launches()
	t0 = time.perf_counter()
	est = fn()
	torch.cuda.synchronize()
	fwd_s, fwd = time.perf_counter() - t0, dict(_common.LAUNCHES)
	_common.reset_launches()
	t0 = time.perf_counter()
	(g,) = torch.autograd.grad(est, leaf)
	torch.cuda.synchronize()
	return {"est": float(est.detach()), "grad": g, "forward": fwd, "backward": dict(_common.LAUNCHES), "forward_s": fwd_s,
		"backward_s": time.perf_counter() - t0, "peak_bytes": torch.cuda.max_memory_allocated()}


def _euler(torch, g, b, est: float, p: int) -> tuple:
	"""Euler's identity for an estimate homogeneous of degree ``p`` in ``b``, with PyTorch's gradient
	``g = ∂L/∂conj(b)``: ``Σ Re(conj(g)·b) = p·est``. Returns the left side and its error over
	``Σ |g|·|b|``, the scale of a sum whose terms cancel (summed in complex128)."""
	g64, b64 = g.to(torch.complex128), b.detach().to(torch.complex128)
	lhs = float(torch.sum(torch.real(g64.conj() * b64)))
	return lhs, abs(lhs - p * est) / float(torch.sum(g64.abs() * b64.abs()))


def _hermitian_backward(torch, tb_op, bsr_op, dev, reps: int) -> dict:
	"""Phase 25 (c): each complex kernel's backward (its Function's) against autograd through its plain
	version on the card, complex64 and complex128: ``dia_stencil_t`` at 16 × n and ``dia_stencil`` at n × 64
	on the Hofstadter bands, ``bsr_spmm`` at the complex BSR cell with k = 64; complex64 also on a
	misaligned block (one element into its buffer, or k = 65) and on lazy conjugate views of the input and
	the cotangent. The cell cases are timed beside the plain version's autograd, and the conjugated
	adjoint bands or tiles that each input gradient's launch reads are timed on their own."""
	from primate_tpu_torch.ops import autograd as kad
	from primate_tpu_torch.ops import bsr, dia

	gen = torch.Generator(device=dev)
	gen.manual_seed(HG_SEED)
	t_start = time.perf_counter()
	n, offs, offsets = tb_op.shape[0], tb_op.offsets_t, tb_op.offsets
	nb, ip, ix = bsr_op.shape[0], bsr_op.indptr, bsr_op.indices
	out = {}

	def crandn(shape, dtype, lead=0):
		flat = torch.randn((lead + int(np.prod(shape)), 2), generator=gen, device=dev, dtype=dtype.to_real())
		return torch.view_as_complex(flat)[lead:].view(shape)

	for dtype in (torch.complex64, torch.complex128):
		tname = str(dtype).removeprefix("torch.")
		pre = "c64_" if dtype == torch.complex64 else "c128_"
		bands = tb_op.bands.to(dtype, copy=True).requires_grad_(True)
		blocks = bsr_op.blocks.to(dtype, copy=True).requires_grad_(True)
		st = lambda b, x: kad.dia_stencil_t_ad(b, x, offs, offsets)  # noqa: E731
		st_ref = lambda b, x: dia.dia_stencil_t_ref(b, offs, x)  # noqa: E731
		nm = lambda b, v: kad.dia_stencil_ad(b, v, offs, offsets)  # noqa: E731
		nm_ref = lambda b, v: dia.dia_stencil_ref(b, offs, v)  # noqa: E731
		sp = lambda b, v: kad.bsr_spmm_ad(b, v, ip, ix, nb)  # noqa: E731
		sp_ref = lambda b, v: bsr.bsr_spmm_ref(b, ip, ix, v, nb)  # noqa: E731
		cases = [  # (label, kernel, Function, plain, input shape, lead, conj views, timed)
			("cell_probe_major", "dia_stencil_t", st, st_ref, (TB_NV, n), 0, False, True),
			("cell_node_major", "dia_stencil", nm, nm_ref, (n, 64), 0, False, True),
			("bsr_cell", "bsr_spmm", sp, sp_ref, (nb, 64), 0, False, True),
		]
		if dtype == torch.complex64:
			cases += [
				("misaligned_probe_major", "dia_stencil_t", st, st_ref, (TB_NV, n), 1, False, False),
				("node_major_k65", "dia_stencil", nm, nm_ref, (n, 65), 0, False, False),
				("bsr_cell_k65", "bsr_spmm", sp, sp_ref, (nb, 65), 0, False, False),
				("conj_view_probe_major", "dia_stencil_t", st, st_ref, (TB_NV, n), 0, True, False),
				("conj_view_node_major", "dia_stencil", nm, nm_ref, (n, 64), 0, True, False),
				("conj_view_bsr_cell", "bsr_spmm", sp, sp_ref, (nb, 64), 0, True, False),
			]
		for label, name, fn, plain, shape, lead, views, timed in cases:
			b = blocks if name == "bsr_spmm" else bands
			x = crandn(shape, dtype, lead).requires_grad_(True)
			G = crandn(shape, dtype)
			if views:  # the input and the cotangent as lazy conjugate views (a conj node's output in autograd)
				x_in, G = x.conj(), G.conj()
			else:
				x_in = x
			y = fn(b, x_in)
			if not type(y.grad_fn).__name__.endswith("Backward"):
				raise AssertionError(f"{name}: the apply did not go through its autograd Function")
			before = dict(dia.LAUNCHES)
			got = torch.autograd.grad(y, (b, x), G, retain_graph=timed)
			launched = dia.LAUNCHES[name] - before[name]
			y_ref = plain(b, x_in)
			want = torch.autograd.grad(y_ref, (b, x), G, retain_graph=timed)
			torch.cuda.synchronize()
			err, rel = _grad_err(torch, got, want)
			row = {"phase": "hermitian_backward_check", "kernel": name, "shape": label, "dtype": tname, "grad_max_abs_err": err,
				"grad_rel_err": rel, "tol": HG_GRAD_TOL[tname], "backward_launches": launched, "at_s": time.perf_counter() - t_start}
			del got, want
			if timed:
				ms, plain_ms = _timed_pair(torch, lambda: torch.autograd.grad(y, (b, x), G, retain_graph=True),
					lambda: torch.autograd.grad(y_ref, (b, x), G, retain_graph=True), reps)
				if name == "bsr_spmm":
					adj = lambda: kad.bsr_adjoint(blocks.detach(), ip, ix, nb)  # noqa: E731
				else:
					adj = lambda: kad.dia_adjoint(bands.detach(), offsets)  # noqa: E731
				adj_ms = time_ms(torch, adj, reps)
				row.update({"backward_ms": ms, "backward_plain_ms": plain_ms, "adjoint_build_ms": adj_ms})
				out.setdefault(name, {}).update({f"{pre}backward_ms": ms, f"{pre}backward_plain_ms": plain_ms,
					f"{pre}adjoint_build_ms": adj_ms})
			entry = out.setdefault(name, {})
			entry[f"{pre}grad_max_abs_err"] = max(entry.get(f"{pre}grad_max_abs_err", 0.0), err)
			del y, y_ref, x, x_in, G
			emit(row)
			if not (rel <= HG_GRAD_TOL[tname] and launched == 1):
				raise AssertionError(f"{name}'s complex backward disagrees with its plain version's autograd: {row}")
		del bands, blocks
		torch.cuda.empty_cache()
	return out


def hermitian_grad(torch, ptt, dev, reps: int = 3) -> dict:
	"""Phase 25: reverse mode on Hermitian operators, ``differentiable=True`` at full width. (a) Phase 15's
	Hofstadter cell (complex64, the bands requiring a gradient): ``hutch`` on 16 phase probes, ``kpm_trace``
	of x² (3 Chebyshev terms on (−4.5, 4.5), undamped: exact for x²) and ``block_slq_trace`` of x² (2 block
	steps of 8, exact for x²); (b) phase 21's complex BSR cell (the tiles requiring a gradient): Hutch++,
	XTrace, XNysTrace and XDiag's sum at phase 21's budgets; (c) :func:`_hermitian_backward`. Each call of
	(a) and (b) holds Euler's identity (degree 1, or 2 for x²), its value to the phase it came from (KPM:
	within 5σ of tr H² = 4n; the sketches: within 1e-3 of tr H; XDiag finite), and its complex64 gradient to
	the complex128 gradient of the same call on the same probes (within ``GRAD_F64_TOL`` of its largest
	entry; (b) at the smaller budgets of ``HG_CROSS``). Returns each kernel's launches in the forward and
	backward passes of (a) and (b) and its numbers from (c)."""
	from primate_tpu_torch import kpm
	from primate_tpu_torch.ops.dia import row_sq_norm

	fwd, bwd = {}, {}
	t_start = time.perf_counter()

	def hold(cell, name, r, leaf, p, ok, r128=None, **fields):
		lhs, euler = _euler(torch, r["grad"], leaf, r["est"], p)
		row = {"phase": "hermitian_grad", "cell": cell, "call": name, "at_s": time.perf_counter() - t_start, "estimate": r["est"],
			"degree": p, "euler_lhs": lhs,
			"euler_rel_err": euler, "euler_tol": HG_EULER_TOL, "forward_s": r["forward_s"], "backward_s": r["backward_s"],
			"peak_bytes": r["peak_bytes"], "forward_launches": r["forward"], "backward_launches": r["backward"], **fields}
		_add(fwd, r["forward"])
		_add(bwd, r["backward"])
		if r128 is not None:
			row["c128_estimate"] = r128["est"]
			row["c64_vs_c128_grad_rel_err"] = float((r["grad"].to(torch.complex128) - r128["grad"]).abs().max() / r128["grad"].abs().max())
			row.update({"c128_peak_bytes": r128["peak_bytes"], "c128_forward_s": r128["forward_s"], "c128_backward_s": r128["backward_s"]})
			ok = ok and row["c64_vs_c128_grad_rel_err"] <= GRAD_F64_TOL
		emit(row)
		if not (ok and euler <= HG_EULER_TOL):
			raise AssertionError(f"Hermitian reverse mode, {cell} {name}, is off: {row}")

	# (a) the Hofstadter cell.
	H = hofstadter_csr(**TB)
	tb = ptt.DIAOperator.from_scipy(H, dtype=torch.complex64, device=dev)
	del H
	n = tb.shape[0]
	emit({"phase": "hermitian_grad_build", "cell": "hofstadter", "at_s": time.perf_counter() - t_start})
	phase, normal = _draw32(ptt, "phase"), _draw32(ptt, "normal")
	calls = {
		"hutch": (1, lambda op, pdf, _: ptt.hutch(op, pdf=pdf, converge="count", count=TB_NV, batch=TB_NV, seed=HG_SEED,
			differentiable=True)),
		"kpm_trace": (2, lambda op, pdf, _: ptt.kpm_trace(op, lambda x: x**2, m=HG_KPM_M, nv=TB_NV, pdf=pdf, interval=(-4.5, 4.5),
			damping="none", seed=HG_SEED, differentiable=True)),
		"block_slq_trace": (2, lambda op, _, pdf: ptt.block_slq_trace(op, lambda x: x**2, b=8, deg=2, nblocks=2, pdf=pdf,
			seed=HG_SEED, differentiable=True)),
	}
	for name, (p, call) in calls.items():
		runs = {}
		for dtype in (torch.complex64, torch.complex128):
			bands = tb.bands.to(dtype, copy=True).requires_grad_(True)
			op = ptt.DIAOperator(bands, tb.offsets, tb.shape)
			c64 = dtype == torch.complex64
			r = _grad_of(torch, lambda: call(op, "phase" if c64 else phase, "normal" if c64 else normal), bands)
			runs[dtype] = (r, bands)
			del op
		(r, bands), (r128, _) = runs[torch.complex64], runs[torch.complex128]
		fields, ok = {}, bool(np.isfinite(r["est"]))
		if name == "kpm_trace":
			with torch.no_grad():
				per = row_sq_norm(tb.matmat_t(kpm._probes(tb, TB_NV, "phase", HG_SEED).T)).double().cpu().numpy()
			sigma = float(per.std(ddof=1) / np.sqrt(TB_NV))
			fields = {"exact": 4.0 * n, "sigma": sigma, "z": (r["est"] - 4.0 * n) / sigma}
			ok = abs(fields["z"]) <= 5.0
		hold("hofstadter", name, r, bands, p, ok, r128, **fields)
		del runs, r, r128, bands
		torch.cuda.empty_cache()

	# (b) the complex BSR cell.
	cb, S, _ = _complex_bsr_op(torch, ptt, dev)
	tr = float(S.diagonal().astype(np.float64).sum())
	emit({"phase": "hermitian_grad_build", "cell": "complex_bsr", "at_s": time.perf_counter() - t_start})
	sketches = {
		"hutchpp": (lambda op, pdf, kw: ptt.hutchpp(op, **kw, pdf=pdf, seed=CBSR_SEED, differentiable=True), dict(m=240), "rademacher"),
		"xtrace": (lambda op, pdf, kw: ptt.xtrace(op, **kw, pdf=pdf, seed=CBSR_SEED, differentiable=True),
			dict(batch=64, converge="count", count=256), "sphere"),
		"xnystrace": (lambda op, pdf, kw: ptt.xnystrace(op, **kw, pdf=pdf, seed=CBSR_SEED, differentiable=True), dict(m=720), "normal"),
		"xdiag": (lambda op, pdf, kw: torch.sum(ptt.xdiag(op, **kw, pdf=pdf, seed=CBSR_SEED, differentiable=True)), dict(m=256), "sphere"),
	}
	for name, (call, budget, pdf) in sketches.items():
		tiles = cb.blocks.detach().clone().requires_grad_(True)
		op = ptt.BSROperator(tiles, cb.indices, cb.indptr, cb.shape)
		r = _grad_of(torch, lambda: call(op, pdf, budget), tiles)
		del op
		torch.cuda.empty_cache()
		cross = {}
		for dtype in (torch.complex64, torch.complex128):  # the cross-check, at HG_CROSS's budget, on the same probes
			t = cb.blocks.to(dtype, copy=True).requires_grad_(True)
			cross[dtype] = _grad_of(torch, lambda: call(ptt.BSROperator(t, cb.indices, cb.indptr, cb.shape), _draw32(ptt, pdf),
				HG_CROSS[name]), t)
			del t
		if name == "xdiag":
			fields, ok = {}, bool(np.isfinite(r["est"]))
		else:
			fields = {"exact": tr, "rel_err": abs(r["est"] - tr) / tr}
			ok = fields["rel_err"] < TRACE_TOL
		g64, g128 = cross[torch.complex64]["grad"], cross[torch.complex128]["grad"]
		fields.update({"cross_budget": HG_CROSS[name], "cross_c64_vs_c128_grad_rel_err":
			float((g64.to(torch.complex128) - g128).abs().max() / g128.abs().max()),
			"cross_s": {str(d).removeprefix("torch."): c["forward_s"] + c["backward_s"] for d, c in cross.items()}})
		ok = ok and fields["cross_c64_vs_c128_grad_rel_err"] <= GRAD_F64_TOL
		hold("complex_bsr", name, r, tiles, 1, ok, budget=budget, **fields)
		del r, cross, g64, g128, tiles
		torch.cuda.empty_cache()

	out = _hermitian_backward(torch, tb, cb, dev, reps)
	emit({"phase": "hermitian_backward_done", "at_s": time.perf_counter() - t_start})
	for k in ("dia_stencil_t", "dia_stencil", "bsr_spmm"):
		out.setdefault(k, {})["hermitian_grad_launches"] = {"forward": fwd.get(k, 0), "backward": bwd.get(k, 0)}
		if bwd.get(k, 0) < 1:
			raise AssertionError(f"{k} launched no complex backward in phase 25 (a)-(b): {bwd}")
	return out


def port_examples(torch, ptt, dev) -> dict:
	"""Phase 22: the five port examples (``primate_tpu_torch.examples``) at their own sizes, each
	``main`` making its checks; their numbers, walls and launches. Returns the phase's launches."""
	import importlib

	from primate_tpu_torch.ops import _common

	total = {}
	for name in ("gp_log_likelihood", "graph_analysis", "rectangular_spectra", "spectrum_slicing", "tight_binding"):
		mod = importlib.import_module(f"primate_tpu_torch.examples.{name}")
		torch.cuda.synchronize()
		_common.reset_launches()
		t0 = time.perf_counter()
		res = mod.main(dev)
		torch.cuda.synchronize()
		wall = time.perf_counter() - t0
		counts = dict(_common.LAUNCHES)
		_add(total, counts)
		res.pop("history", None)
		emit({"phase": "port_example", "example": name, "wall_s": wall, "launches": counts, "result": res})
	emit({"phase": "port_example", "example": "launches", "launches": total})
	if total.get("dia_stencil", 0) < 1 or total.get("dia_stencil_t", 0) < 1:
		raise AssertionError(f"the examples launched no DIA stencil: {total}")
	return total


# Phase 23: the sharded path. (a) one rank over NCCL on the card: the 10M flagship (orth 0 and 5) and
# both layouts of the global face through ShardedDIAOperator against the unsharded operator on the
# same blocks, phase 7's
# sketches through ShardedBSROperator and phase 9's logdet through ShardedCSROperator (both
# comm="allgather": at one rank a halo would be the whole block). (b) two ranks over gloo, both on
# cuda:0, as subprocesses: the flagship at SHARD_N through the halo DIA operator and through an
# allgather BSR one, each on an (op, probe) mesh of (2, 1) and (1, 2).
SHARD_N, SHARD_NM_K, SHARD_TIMEOUT_S = 500_000, 8, 300


def _free_port() -> int:
	import socket

	with socket.socket() as s:
		s.bind(("localhost", 0))
		return s.getsockname()[1]


def _sharded_flagship(torch, ptt, op, orth: int) -> tuple:
	"""The flagship call on ``op`` (unsharded or sharded), its launches, wall and peak memory."""
	M = ptt.MatrixFunction(op, fun="log", deg=DEG, orth=orth, reorth_passes=1, dtype=torch.float32)
	return _timed_calls(torch, lambda: ptt.hutch(M, batch=PROBES, converge="count", count=PROBES, seed=42), reps=1)


def sharded_one_rank(torch, ptt, dev) -> dict:
	"""Phase 23 (a): world size 1 over NCCL, in this process. Returns the launches of the sharded calls."""
	from primate_tpu_torch.lanczos import lanczos_block_op
	from primate_tpu_torch.ops import _common, dia
	from primate_tpu_torch.parallel import ShardedBSROperator, ShardedCSROperator, initialize_distributed, make_mesh, shard_operator
	from primate_tpu_torch.random import sample_isotropic
	from primate_tpu_torch.trace import _base_seed, batch_generator

	total = {}
	torch.cuda.set_device(dev)
	initialize_distributed("nccl", init_method=f"tcp://localhost:{_free_port()}", world_size=1, rank=0)
	mesh = make_mesh((1, 1), ("op", "probe"))
	L = build_laplacian(N_LARGE)
	op = ptt.DIAOperator.from_scipy(L, dtype=torch.float32, device=dev)
	sop = shard_operator(op, mesh)
	exact = exact_logdet(N_LARGE)
	# The same probes through both: α and β of the first batch's sweep.
	V = sample_isotropic(batch_generator(_base_seed(42), 0, dev), (N_LARGE, PROBES), pdf="rademacher", dtype=torch.float32)
	for orth in (0, 5):
		ab = [lanczos_block_op(o, V, deg=DEG, ncv=max(2, orth), orth=orth, reorth_passes=1, return_basis=False) for o in (op, sop)]
		ab_err = max(float((s - u).abs().max() / u.abs().max()) for s, u in ((ab[1].alphas, ab[0].alphas), (ab[1].betas, ab[0].betas)))
		del ab
		rows = {}
		for name, o in (("unsharded", op), ("sharded", sop)):
			est, counts, _, times, peak = _sharded_flagship(torch, ptt, o, orth)
			rows[name] = {"estimate": est, "rel_err": abs(est - exact) / abs(exact), "wall_s": times[0],
				"max_memory_allocated_bytes": peak, "launches": counts}
		torch.cuda.empty_cache()
		row = {"phase": "sharded_flagship", "world": 1, "backend": "nccl", "n": N_LARGE, "deg": DEG, "orth": orth, "probes": PROBES,
			"exact": exact, "alpha_beta_rel_err": ab_err, "estimate_rel_diff": abs(rows["sharded"]["estimate"] - rows["unsharded"]["estimate"])
			/ abs(rows["unsharded"]["estimate"]), "overhead": rows["sharded"]["wall_s"] / rows["unsharded"]["wall_s"], **rows}
		emit(row)
		if not (ab_err < ALPHA_TOL["float32"] and row["estimate_rel_diff"] < ALPHA_TOL["float32"] and rows["sharded"]["rel_err"] < 0.05):
			raise AssertionError(f"the sharded flagship (orth={orth}) disagrees: {row}")
		# One batch of PROBES: the sharded sweep runs the step kernels on its padded carry, pass A a
		# step, and at orth = 0 pass B a step and the advance kernel once, for the last step's finish
		# (each other step's runs in the next step's pass A); no plain-step stencil.
		got = {k: rows["sharded"]["launches"][k] for k in ("lanczos_dia_step", "lanczos_dia_residual", "lanczos_dia_advance", "dia_stencil_t")}
		want = {"lanczos_dia_step": DEG, "lanczos_dia_residual": DEG if orth == 0 else 0, "lanczos_dia_advance": 1 if orth == 0 else 0,
			"dia_stencil_t": 0}
		if orth == 0:
			ADVANCE_A_SWEEP[f"sharded_{N_LARGE}_float32"] = got["lanczos_dia_advance"]
		if got != want:
			raise AssertionError(f"the sharded sweep (orth={orth}) launched {got}, expected {want}")
		_add(total, rows["sharded"]["launches"])
	# lanczos_block_op(phys=True): the unsharded sweep on the padded carry against the flat one.
	for orth in (0, 5):
		dia.reset_launches()
		got, want = (lanczos_block_op(op, V, deg=DEG, ncv=max(2, orth), orth=orth, reorth_passes=1, return_basis=False, phys=p)
			for p in (True, False))
		err = max(float((g - w).abs().max() / w.abs().max()) for g, w in ((got.alphas, want.alphas), (got.betas, want.betas)))
		row = {"phase": "phys_carry", "n": N_LARGE, "deg": DEG, "orth": orth, "probes": PROBES, "alpha_beta_rel_err": err,
			"spec": list(op.carry_spec(PROBES)), "launches": dict(dia.LAUNCHES), "scalar_launches": dict(_common.SCALAR_LAUNCHES)}
		emit(row)
		if not err < ALPHA_TOL["float32"] or dia.LAUNCHES["lanczos_dia_step"] != 2 * DEG:
			raise AssertionError(f"lanczos_block_op(phys=True) disagrees with the flat sweep or skipped pass A: {row}")
		del got, want
	torch.cuda.empty_cache()
	# The global face at the flagship shape: a replicated block in, the whole product out, through
	# the probe-major and the node-major stencil, against the unsharded operator on the same block.
	gen = torch.Generator(device=dev)
	gen.manual_seed(23)
	blocks = {"probe_major": (torch.randn((PROBES, N_LARGE), generator=gen, device=dev), "matmat_t", "dia_stencil_t"),
		"node_major": (torch.randn((N_LARGE, SHARD_NM_K), generator=gen, device=dev), "matmat", "dia_stencil")}
	for label, (X, method, kernel) in blocks.items():
		dia.reset_launches()
		got = getattr(sop, method)(X)
		torch.cuda.synchronize()
		counts, scalar = dict(dia.LAUNCHES), _common.SCALAR_LAUNCHES[kernel]
		want = getattr(op, method)(X)
		err = float((got - want).abs().max() / want.abs().max())
		row = {"phase": "sharded_apply", "layout": label, "shape": list(X.shape), "max_abs_err": err, "launches": counts,
			"scalar_launches": scalar, "sharded_ms": time_ms(torch, lambda: getattr(sop, method)(X), 5),
			"unsharded_ms": time_ms(torch, lambda: getattr(op, method)(X), 5)}
		emit(row)
		# The rank's window is the padded carry's width (a whole number of 16-byte vectors): the
		# probe-major stencil takes its vector path there.
		if not err < STENCIL_TOL["float32"] or counts[kernel] != 1 or (kernel == "dia_stencil_t" and scalar):
			raise AssertionError(f"the sharded {label} apply is off, or {kernel} did not launch once on its vector path: {row}")
		_add(total, counts)
		del got, want
	del blocks, X
	del op, sop, V
	torch.cuda.empty_cache()

	S = _bsr_cell(**BSR_CELL)
	tr = float(S.diagonal().astype(np.float64).sum())
	diag_s = S.diagonal().astype(np.float64)
	bop = ShardedBSROperator.from_bsr(S, mesh, comm="allgather", blocksize=(BSR_CELL["bs"],) * 2, dtype=torch.float32, device=dev)
	calls = {
		"hutchpp": lambda: ptt.hutchpp(bop, m=240, seed=7),
		"xtrace": lambda: ptt.xtrace(bop, batch=64, converge="count", count=256, seed=7),
		"xdiag": lambda: ptt.xdiag(bop, m=256, seed=7),
	}
	for name, fn in calls.items():
		est, counts, copies, times, peak = _timed_calls(torch, fn, reps=1)
		row = {"phase": "sharded_bsr_sketch", "call": name, "comm": bop.comm, "wall_s": times[0], "max_memory_allocated_bytes": peak,
			"launches": counts, "layout_copies": copies}
		if name == "xdiag":
			row["diag_rel_l2_err"] = float(np.linalg.norm(est - diag_s) / np.linalg.norm(diag_s))
			ok = bool(np.all(np.isfinite(est))) and est.shape == diag_s.shape
		else:
			row.update({"estimate": est, "exact": tr, "rel_err": abs(est - tr) / tr})
			ok = row["rel_err"] < TRACE_TOL
		emit(row)
		if not ok or counts["bsr_spmm"] != BSR_APPLIES[name]:
			raise AssertionError(f"sharded {name} on the BSR cell is off, or bsr_spmm did not launch once an apply: {row}")
		_add(total, counts)
	del bop
	torch.cuda.empty_cache()

	G = _powerlaw(PL_N)
	cop = ShardedCSROperator.from_csr(G, mesh, comm="allgather", dtype=torch.float32, device=dev)
	M = ptt.MatrixFunction(cop, "log", deg=SLQ_CSR["deg"], orth=SLQ_CSR["orth"], dtype=torch.float32)
	est, counts, copies, times, peak = _timed_calls(
		torch, lambda: ptt.hutch(M, batch=SLQ_CSR["batch"], converge="count", count=SLQ_CSR["count"], seed=9), reps=1
	)
	upper = float(np.sum(np.log(G.diagonal().astype(np.float64))))
	row = {"phase": "sharded_csr_slq", "n": PL_N, "comm": cop.comm, "estimate": est, "lower": 0.0, "upper": upper,
		"wall_s": times[0], "max_memory_allocated_bytes": peak, "launches": counts, "layout_copies": copies}
	emit(row)
	if not 0.0 <= est <= upper:
		raise AssertionError(f"sharded CSR logdet {est} outside [0, {upper}]")
	del cop, M
	torch.distributed.destroy_process_group()
	torch.cuda.empty_cache()
	return total


def sharded_rank(rank: int, world: int, store: str, device: str = "cuda", dtype: str = "float32") -> None:
	"""Phase 23 (b), one rank: over gloo, on cuda:0 (the collectives staged through host memory), meeting
	the other ranks through the file ``store`` (``file://`` rendezvous: no port to probe). With
	``dtype="bfloat16"``, phase 24 (e): the full-bf16 flagship through the halo DIA operator on the
	(world, 1) mesh alone. The operators and meshes, and so their process groups, are freed before the
	ranks meet at a barrier and destroy the default group: left to the interpreter's exit, a gloo group
	freed there aborted the process now and then ("terminate called without an active exception")."""
	import gc

	import torch

	from primate_tpu_torch.parallel import initialize_distributed

	dev = torch.device(device, 0) if device == "cuda" else torch.device(device)
	if dev.type == "cuda":
		torch.cuda.set_device(dev)
	initialize_distributed("gloo", init_method=f"file://{store}", world_size=world, rank=rank)
	_sharded_rank_calls(torch, rank, world, dev, getattr(torch, dtype))
	gc.collect()
	torch.distributed.barrier()
	torch.distributed.destroy_process_group()


def _sharded_rank_calls(torch, rank: int, world: int, dev, dt) -> None:
	"""The calls of :func:`sharded_rank`; every operator and mesh they make dies with this frame."""
	import primate_tpu_torch as ptt
	from primate_tpu_torch.ops import _common
	from primate_tpu_torch.parallel import make_mesh, shard_operator

	dtype = str(dt).removeprefix("torch.")
	L = build_laplacian(SHARD_N)
	for shape in ((world, 1), (1, world)) if dt == torch.float32 else ((world, 1),):
		mesh = make_mesh(shape, ("op", "probe"), device_type=dev.type)
		makers = (
			("halo", lambda: shard_operator(ptt.DIAOperator.from_scipy(L, dtype=dt, device="cpu"), mesh, probe_axis="probe", device=dev)),
			("allgather", lambda: shard_operator(L, mesh, probe_axis="probe", comm="allgather", blocksize=(8, 8), dtype=dt, device=dev)),
		)
		for comm, make in makers if dt == torch.float32 else makers[:1]:
			op = make()
			M = ptt.MatrixFunction(op, fun="log", deg=DEG, orth=ORTH, reorth_passes=1, dtype=dt)
			torch.cuda.synchronize()
			_common.reset_launches()
			t0 = time.perf_counter()
			est = ptt.hutch(M, batch=PROBES, converge="count", count=PROBES, seed=42)
			torch.cuda.synchronize()
			emit({"phase": "sharded_rank", "rank": rank, "world": world, "mesh": list(shape), "comm": comm, "kind": type(op).__name__,
				"dtype": dtype, "estimate": est, "estimate_hex": float(est).hex(), "wall_s": time.perf_counter() - t0,
				"launches": dict(_common.LAUNCHES), "bf16_launches": dict(_common.BF16_LAUNCHES)})


def _run_ranks(world: int, *extra: str) -> list:
	"""``world`` ranks of :func:`sharded_rank` as subprocesses of this script, meeting through a file store
	in a fresh temporary directory; each rank's JSON lines. Raises if a rank fails."""
	import tempfile

	with tempfile.TemporaryDirectory() as tmp:
		store = f"{tmp}/store"
		procs = [
			subprocess.Popen([sys.executable, __file__, "--sharded-rank", str(r), str(world), store, *extra], stdout=subprocess.PIPE,
				stderr=subprocess.PIPE, text=True)
			for r in range(world)
		]
		outs = []
		try:
			for p in procs:
				out, err = p.communicate(timeout=SHARD_TIMEOUT_S)
				if p.returncode != 0:
					raise AssertionError(f"a sharded rank failed ({p.returncode}):\n{out[-2000:]}\n{err[-4000:]}")
				outs.append([json.loads(line) for line in out.splitlines() if line.startswith("{")])
		finally:
			for p in procs:
				if p.poll() is None:
					p.kill()
					p.wait()
	return outs


def sharded_two_ranks(torch) -> dict:
	"""Phase 23 (b): two gloo ranks on the one card, as subprocesses of this script. Both must print the
	same estimate bit for bit, within 5% of the exact logdet, and each its kernels' launches."""
	outs = _run_ranks(2)
	exact = exact_logdet(SHARD_N)
	total = {}
	for r0, r1 in zip(*outs):
		row = {"phase": "sharded_two_ranks", "world": 2, "backend": "gloo", "n": SHARD_N, "mesh": r0["mesh"], "comm": r0["comm"],
			"kind": r0["kind"], "estimates": [r0["estimate"], r1["estimate"]], "exact": exact, "rel_err": abs(r0["estimate"] - exact) / abs(exact),
			"wall_s": [r0["wall_s"], r1["wall_s"]], "launches": [r0["launches"], r1["launches"]]}
		emit(row)
		# The halo DIA operator's sweep runs the step kernels (pass A and pass B a step, the advance once
		# for the last step) on every rank, and no plain-step stencil; the allgather BSR operator's runs bsr_spmm.
		kernels = ("lanczos_dia_step", "lanczos_dia_residual", "lanczos_dia_advance") if r0["comm"] == "halo" else ("bsr_spmm",)
		if r0["estimate_hex"] != r1["estimate_hex"] or not row["rel_err"] < 0.05:
			raise AssertionError(f"the two ranks disagree or miss the logdet: {row}")
		if min(r[k] for r in (r0["launches"], r1["launches"]) for k in kernels) < 1 or (
			r0["comm"] == "halo" and max(r0["launches"]["dia_stencil_t"], r1["launches"]["dia_stencil_t"]) > 0
		):
			raise AssertionError(f"{kernels} did not launch on every rank (or the plain step ran): {row}")
		if r0["comm"] == "halo":
			advances = [r["launches"]["lanczos_dia_advance"] for r in (r0, r1)]
			ADVANCE_A_SWEEP[f"gloo_{SHARD_N}_float32_mesh{r0['mesh'][0]}x{r0['mesh'][1]}"] = advances
			if advances != [1, 1]:
				raise AssertionError(f"a gloo rank's sweep launched the advance kernel {advances} times, not once: {row}")
		for r in (r0, r1):
			_add(total, r["launches"])
	return total


# Phase 24: bfloat16 operators (JAX's third operator dtype): the four kernels' bf16 instantiations
# against their plain versions at the path's shapes, timed beside their bounds at 2-byte elements;
# JAX's full-bf16 SLQ (benchmarks/RESULTS.md:294-305: a bf16 DIAOperator and
# MatrixFunction(..., dtype=bfloat16)) at 500k and 10M beside the float32 flagship in this process;
# the plain trace on the bf16 DIA operator; a node-major apply of the bf16 FEM operator; the bf16 BSR
# trace on phase 7's cell against the float32 one on the same probes; the sharded bf16 flagship on one
# NCCL rank at 10M and on two gloo ranks at SHARD_N.
BF16_KERNELS = ("dia_stencil_t", "lanczos_dia_step", "lanczos_dia_round", "dia_stencil", "bsr_spmm")
BF16_W_RTOL = 1e-5  # pass A's float32 w (unrounded) and α, relative to their largest entry
BF16_SHARD_TOL = 1e-3  # the sharded bf16 estimate against the unsharded one on the same probes
BF16_BSR_TOL = 1e-2  # the bf16 BSR trace against the float32 one on the same probes
BF16_FLIP_SHARE = 1e-4  # rounded pass A: the most entries whose stencil sum rounds to the other bf16 neighbour
# The bf16 times of the kernels that the bf16 register kernels of pass A and dia_stencil_t replaced (the staged pass A,
# the probe-major kernel with float32 band values), quoted from PERF.md §6 beside this run's times, not measured here:
# NVIDIA H100 80GB HBM3, 700.00 W. Keyed by (kernel, n) at 64 probes and the flagship's 3 diagonals.
BF16_PREDECESSOR_MS = {("dia_stencil_t", N_FLAGSHIP): 0.0944, ("lanczos_dia_step", N_FLAGSHIP): 0.1681, ("lanczos_dia_step", N_LARGE): 2.675}


def _rademacher_f32(g, shape, dtype):
	"""The same Rademacher probes for every dtype: drawn in float32, cast to the operator's dtype."""
	import torch
	from primate_tpu_torch.random import sample_isotropic

	return sample_isotropic(g, shape, pdf="rademacher", dtype=torch.float32).to(dtype)


def _ulp_of_max(want) -> float:
	"""One bfloat16 ulp of a tensor's largest entry, 2^(⌊log2 max⌋ − 7): the tolerance of a bf16 output
	against its plain version, which sums the same float32 products in another order (a sum within a
	float32 ulp of a rounding boundary may round to the neighbouring bf16 value)."""
	return 2.0 ** (np.floor(np.log2(float(want.float().abs().max()))) - 7)


def _csr_or_refusal(torch, bands, offsets, n: int):
	"""The bf16 DIA operator as a CUDA CSR tensor for the library yardstick, or the reason torch refuses it."""
	try:
		return csr_of_dia(torch, bands, offsets, n), None
	except (RuntimeError, NotImplementedError, TypeError) as e:
		return None, f"{type(e).__name__}: {e}"[:300]


def rounded_pass_a_check(torch, dia, w, alpha, bands, offsets, q, qp, beta) -> dict:
	"""Pass A rounded (the flat and sharded bf16 step) against its plain version on the same inputs. Every
	entry of ``w`` lies within BF16_W_RTOL of max|w| of the rounded plain ``w``, except flips: a stencil sum
	within a float32 ulp of a bf16 rounding boundary, summed in another order, rounds to the other
	neighbour, one bf16 ulp of that sum away; at most BF16_FLIP_SHARE of the entries flip. ``w`` lies
	nearer the rounded plain version than the unrounded one (a kernel that ignores the switch lies
	within half a bf16 ulp of both). α within BF16_W_RTOL relative."""
	w_r, alpha_r = dia.lanczos_dia_step_ref(bands, offsets, q, qp, beta)
	d = (w - w_r).abs()
	tol = BF16_W_RTOL * float(w_r.abs().max())
	unflipped = d <= tol
	del w_r
	s = dia._stencil_t_acc(bands, offsets, q)
	ulp = torch.exp2(torch.floor(torch.log2(s.abs())) - 7)  # one bf16 ulp of each stencil sum (0 where it is 0)
	flip = ~unflipped & (d <= ulp + tol)
	flips, stray = int(flip.sum()), int((~unflipped & ~flip).sum())
	err_rounded = float(d.double().mean())
	del s, ulp, flip
	err_unflipped = float(torch.where(unflipped, d, 0).max())
	del d, unflipped
	w_u, _ = dia.lanczos_dia_step_ref(bands, offsets, q, qp, beta, rounded=False)
	err_unrounded = float((w - w_u).abs().double().mean())
	del w_u
	err_a = float(((alpha - alpha_r).abs() / alpha_r.abs()).max())
	ok = stray == 0 and flips <= BF16_FLIP_SHARE * w.numel() and err_rounded < err_unrounded and err_a <= BF16_W_RTOL
	return {"ok": ok, "tol": tol, "max_abs_err_unflipped": err_unflipped, "rounding_flips": flips, "stray_entries": stray,
		"mean_abs_err_vs_rounded": err_rounded, "mean_abs_err_vs_unrounded": err_unrounded, "alpha_rel_err": err_a}


def _bf16_flips(torch, got, want) -> tuple:
	"""Entries of two bf16 blocks that differ, those that differ by more than one bf16 ulp, and the largest difference."""
	d = (got.float() - want.float()).abs()
	ulp = torch.exp2(torch.floor(torch.log2(torch.maximum(got.float().abs(), want.float().abs()))) - 7)
	return int((d > 0).sum()), int((d > ulp).sum()), float(d.max())


def check_round_finish(torch, dia, w, q, alpha, beta, spec, tol: float, label: str) -> dict:
	"""Phase 24 (a): the round pair in the finishing mode (a row-sharded bf16 step's: B1 writes Σv² to ``sums[1]``,
	an identity all-reduce, then B2 finishes the step from the sums) through the wrapper the sharded step calls,
	``lanczos_dia_round(..., reduce, sums)``, with probe 0 done before the step and probe 1 breaking down in it
	(its w and α zero). Held to ``lanczos_dia_advance_ref`` on the kernel's own reduced sums: the state rows and
	``alpha_out``/``beta_out`` bit for bit; and to ``lanczos_round_pair_ref`` (its own sums): ``alpha_out`` and the
	done flags equal, ``beta_out`` within 1e-6 relative, ``q_next`` within B2's flip rules, margins zero. Raises
	if any of these fails."""
	nv, dev = q.shape[0], q.device
	gen = torch.Generator(device=dev)
	gen.manual_seed(241)
	a_in, w_in = alpha.clone(), w.clone()
	a_in[1], w_in[1] = 0.0, 0.0
	div0 = torch.rand(nv, generator=gen, device=dev) + 0.5

	def state():
		st = dia.lanczos_state(nv, torch.float32, dev)
		st.scal[dia.DIV_CUR], st.scal[dia.ALPHA], st.scal[dia.BETA] = div0, a_in, beta
		st.scal[dia.DONE, 0] = 1.0
		return st

	def sums():
		return torch.stack([a_in, torch.zeros_like(a_in)])

	same = lambda t: t  # noqa: E731  (one rank: the all-reduce is the identity)
	st_k, ab_k, sums_k = state(), torch.empty((2, nv), device=dev), sums()
	q_k = dia.lanczos_dia_round(w_in, q, st_k, ab_k[0], ab_k[1], tol, spec, same, sums_k)
	st_a, ab_a = state(), torch.empty((2, nv), device=dev)
	dia.lanczos_dia_advance_ref(sums_k.clone(), st_a, ab_a[0], ab_a[1], tol)
	st_r, ab_r = state(), torch.empty((2, nv), device=dev)
	q_r = dia.lanczos_round_pair_ref(w_in, q, st_r, ab_r[0], ab_r[1], tol, spec, same, sums())
	torch.cuda.synchronize()
	flips, stray, err = _bf16_flips(torch, q_k, q_r)
	cases = bool(ab_k[0, 0] == 0 and ab_k[1, 0] == 0 and st_k.scal[dia.DONE, :2].eq(1).all() and torch.isinf(st_k.scal[dia.DIV_CUR, 1])
		and not q_k[1].any())
	row = {"phase": "bf16_round_finish_check", "kernel": "lanczos_dia_round", "shape": label,
		"state_and_outputs_bits_equal_advance": torch.equal(st_k.scal, st_a.scal) and torch.equal(ab_k, ab_a),
		"alpha_and_done_equal": torch.equal(ab_k[0], ab_r[0]) and torch.equal(st_k.scal[dia.DONE], st_r.scal[dia.DONE]),
		"beta_rel_err": float(((ab_k[1] - ab_r[1]).abs() / ab_r[1].abs().clamp_min(1e-30)).max()),
		"done_and_breakdown_probes": cases, "q_next_flips": flips, "q_next_stray": stray, "max_abs_err": err,
		"margins_zero": not (q_k[:, : spec.lo].any() or q_k[:, spec.lo + spec.n :].any())}
	emit(row)
	del w_in, q_k, q_r
	if not (row["state_and_outputs_bits_equal_advance"] and row["alpha_and_done_equal"] and row["beta_rel_err"] <= 1e-6 and cases
			and stray == 0 and flips <= BF16_FLIP_SHARE * q.numel() and row["margins_zero"]):
		raise AssertionError(f"the round pair's finishing mode disagrees with its plain versions at {label}: {row}")
	return {"finishing_beta_rel_err": row["beta_rel_err"], "finishing_q_next_flips": flips}


def check_round_pair(torch, dia, lib, w, q, alpha, beta, spec, label: str, reps: int = 10) -> dict:
	"""Phase 24 (a): the round pair (``lanczos_dia_round``: B1, the norm and the step's scalars; B2, the
	rounded ``q_next``) against its plain version, the PyTorch tail it replaces, on pass A's plain
	output ``w``/α at a flagship shape: the α outputs and the done flags equal, β' within 1e-6 relative,
	``q_next`` equal but for flips of one bf16 ulp on at most BF16_FLIP_SHARE of its entries, its margins
	zero. B1, B2 and the pair timed beside their bounds (6, 8 and 14 bytes an element), the pair
	beside the tail (plain, kernel, kernel, plain), B2 in the finishing mode too; the finishing mode held
	to its plain versions (:func:`check_round_finish`). Returns the numbers for the ``kernels`` line."""
	from primate_tpu_torch.ops import _common

	nv, n, dev = q.shape[0], spec.n, q.device
	tol = float(np.sqrt(n) * 1e-8)

	def state():
		st = dia.lanczos_state(nv, torch.float32, dev)
		st.scal[dia.ALPHA], st.scal[dia.BETA] = alpha, beta
		return st

	outs = []
	for fn in (dia.lanczos_dia_round, dia.lanczos_dia_round_ref):
		st, ab = state(), torch.empty((2, nv), device=dev)
		outs.append((fn(w.clone(), q, st, ab[0], ab[1], tol, spec), ab, st.scal))
	torch.cuda.synchronize()
	(q_k, ab_k, s_k), (q_r, ab_r, s_r) = outs
	beta_err = float(((ab_k[1] - ab_r[1]).abs() / ab_r[1].abs()).max())
	flips, stray, err = _bf16_flips(torch, q_k, q_r)
	del outs, q_r
	margins = not (q_k[:, : spec.lo].any() or q_k[:, spec.lo + n :].any())
	same = torch.equal(ab_k[0], ab_r[0]) and torch.equal(s_k[dia.DONE], s_r[dia.DONE])

	gx = lib.lanczos_round_blocks(nv, n)
	partial = torch.empty((nv, gx), device=dev)
	vec = _common.vector_ok(spec.ld, q.element_size(), w, q, q_k, lead=spec.lo)
	st1, st2, ab = state(), state(), torch.empty((2, nv), device=dev)
	stream = _common.stream(dev)
	b1 = lambda: lib.lanczos_dia_round_norm_bf16(  # noqa: E731
		w.data_ptr(), q.data_ptr(), st1.scal.data_ptr(), st1.scal[dia.ALPHA].data_ptr(), partial.data_ptr(), st1.ticket.data_ptr(),
		ab[0].data_ptr(), ab[1].data_ptr(), None, nv, spec.ld, spec.lo, n, tol, gx, int(vec), stream)
	b2 = lambda: lib.lanczos_dia_round_write_bf16(  # noqa: E731
		w.data_ptr(), q.data_ptr(), st2.scal.data_ptr(), None, None, None, q_k.data_ptr(), nv, spec.ld, spec.lo, n, tol, gx, int(vec),
		stream)
	# B2 in the finishing mode (a row-sharded step's): the step's scalars from the reduced sums, its first blocks the finish.
	sums, st3 = torch.stack([alpha, torch.rand(nv, device=dev) + 0.5]), state()
	q_f = torch.empty_like(q_k)
	b2_fin = lambda: lib.lanczos_dia_round_write_bf16(  # noqa: E731
		w.data_ptr(), q.data_ptr(), st3.scal.data_ptr(), sums.data_ptr(), ab[0].data_ptr(), ab[1].data_ptr(), q_f.data_ptr(), nv,
		spec.ld, spec.lo, n, tol, gx, int(vec), stream)
	if b1() != 0 or b2() != 0 or b2_fin() != 0:
		raise AssertionError(f"the round pair did not launch at {label}")
	st_p, w_p = state(), w.clone()
	ms, plain_ms = _timed_pair(
		torch, lambda: dia.lanczos_dia_round(w, q, st_p, ab[0], ab[1], tol, spec),
		lambda: dia.lanczos_dia_round_ref(w_p, q, st_p, ab[0], ab[1], tol, spec), reps,
	)
	b1_ms, b2_ms = time_ms(torch, b1, reps), time_ms(torch, b2, reps)
	b2_fin_ms = time_ms(torch, b2_fin, reps)
	(b_ms, b_by), (b1_bound, _), (b2_bound, _) = (bound(k * nv * n, f * nv * n) for k, f in ((14, 7), (6, 4), (8, 3)))
	note = "none: no single PyTorch call computes ||w - alpha q|| and the rounded quotient"
	row = {"phase": "bf16_round_check", "kernel": "lanczos_dia_round", "shape": label, "spec": list(spec), "vector_path": vec,
		"beta_rel_err": beta_err, "alpha_and_done_equal": same, "q_next_flips": flips, "q_next_entries": q_k.numel(),
		"q_next_stray": stray, "max_abs_err": err, "margins_zero": margins, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
		"bound_by": b_by, "b1_ms": b1_ms, "b1_bound_ms": b1_bound, "b2_ms": b2_ms, "b2_bound_ms": b2_bound,
		"b2_finishing_ms": b2_fin_ms, "GBps": 14 * nv * n / ms / 1e6, "library_ms": None, "library_note": note}
	emit(row)
	if not (same and beta_err <= 1e-6 and stray == 0 and flips <= BF16_FLIP_SHARE * q_k.numel() and margins and vec):
		raise AssertionError(f"the round pair disagrees with the PyTorch tail or left its vector path at {label}: {row}")
	del q_k, q_f, st1, st2, st3, st_p, w_p
	fin = check_round_finish(torch, dia, w, q, alpha, beta, spec, tol, label)
	return {**{k: row[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "b1_ms", "b1_bound_ms", "b2_ms",
		"b2_bound_ms", "b2_finishing_ms", "beta_rel_err", "q_next_flips")}, **fin}


def bf16_kernels(torch, ptt, dev, reps: int = 10) -> dict:
	"""Phase 24 (a): each bf16 kernel against its bf16 plain version on the same inputs at the path's
	shapes, timed (plain, kernel, kernel, plain) beside its bound (2-byte elements; pass A writes float32)
	and its library call where torch has one in bf16. Returns ``{kernel: {"bf16_ms", ...}}``."""
	from benchmarks.matrices import fem_laplacian_3d
	from primate_tpu_torch.ops import _common, bsr, dia
	from primate_tpu_torch.ops._build import load_library

	lib = load_library()
	bf = torch.bfloat16
	gen = torch.Generator(device=dev)
	gen.manual_seed(24)
	out = {}

	def record(name, label, err, tol, kern, plain, bytes_, flops, library=None, want=None, note=None, prefix="bf16_", float32=None,
			**extra):
		"""``float32``: the float32 instantiation on the same block, timed in turns with the kernel and its plain
		version (plain, float32, kernel, kernel, float32, plain) into the row's ``float32_ms``."""
		if float32 is None:
			ms, plain_ms = _timed_pair(torch, kern, plain, reps)
		else:
			plain_ms, extra["float32_ms"], ms = _timed_turns(torch, (plain, float32, kern), reps)
		b_ms, b_by = bound(bytes_, flops, BF16_FLOP_PER_S)
		lib_ms = None
		if library is not None:
			lib_ms, note = library_ms(torch, library, want, reps)
		row = {"phase": "bf16_kernel_check", "kernel": name, "shape": label, "max_abs_err": err, "tol": tol, "ms": ms,
			"plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "share_of_bound": b_ms / ms, "GBps": bytes_ / ms / 1e6,
			"library_ms": lib_ms, "library_rel_err_or_error": note, **extra}
		emit(row)
		if not err <= tol:
			raise AssertionError(f"the bf16 {name} disagrees with its plain version: {row}")
		out.setdefault(name, {}).update({f"{prefix}{k}": v for k, v in (("max_abs_err", err), ("ms", ms), ("plain_ms", plain_ms),
			("bound_ms", b_ms), ("bound_by", b_by), ("library_ms", lib_ms))})

	# The flagship's operator and probe block: tridiag(-1, 3, -1) in bf16 (exact), unit rows.
	for n in (N_FLAGSHIP, N_LARGE):
		op = ptt.DIAOperator.from_scipy(build_laplacian(n), dtype=bf, device=dev)
		bands, offs, offs_host, nv, n_d = op.bands, op.offsets_t, op.offsets_t.cpu(), PROBES, len(op.offsets)
		unit = lambda X: (X / torch.linalg.vector_norm(X, dim=1, keepdim=True)).to(bf)  # noqa: E731
		q, qp = unit(torch.randn((nv, n), generator=gen, device=dev)), unit(torch.randn((nv, n), generator=gen, device=dev))
		beta = torch.rand(nv, generator=gen, device=dev) + 0.5
		scal = torch.stack([torch.ones_like(beta), torch.ones_like(beta), beta, torch.zeros_like(beta), torch.zeros_like(beta)])
		tag = "500k" if n == N_FLAGSHIP else "10M"
		if n == N_FLAGSHIP:
			got, want = dia.dia_stencil_t(bands, offs, q), dia.dia_stencil_t_ref(bands, offs_host, q)
			torch.cuda.synchronize()
			A_csr, refusal = _csr_or_refusal(torch, bands, op.offsets, n)
			record("dia_stencil_t", f"flagship_{nv}x{n}", float((got.float() - want.float()).abs().max()), _ulp_of_max(want),
				lambda: dia.dia_stencil_t(bands, offs, q), lambda: dia.dia_stencil_t_ref(bands, offs_host, q),
				(2 * nv * n + n_d * n) * 2, 2 * n_d * nv * n, library=(lambda: A_csr @ q.T) if A_csr is not None else None,
				want=want.T, note=refusal, predecessor_ms_quoted=BF16_PREDECESSOR_MS[("dia_stencil_t", n)])
			del A_csr, got, want
			# Pass A unrounded on the padded carry (phys=True's step) against its plain version.
			spec = op.carry_spec(nv)
			cb, qs, qps = op._carry_bands(spec), spec.pad(q), spec.pad(qp)
			w, alpha = dia.lanczos_dia_step(cb, offs, qs, qps, beta, spec, rounded=False)
			w_ref, alpha_ref = dia.lanczos_dia_step_ref(cb, offs_host, qs, qps, beta, spec, rounded=False)
			torch.cuda.synchronize()
			err_w = float((w - w_ref).abs().max()) / float(w_ref.abs().max())
			err_a = float(((alpha - alpha_ref).abs() / alpha_ref.abs()).max())
			row = {"phase": "bf16_kernel_check", "kernel": "lanczos_dia_step", "shape": f"padded_{nv}x{n}", "rounded": False,
				"spec": list(spec), "w_rel_err": err_w, "alpha_rel_err": err_a, "tol": BF16_W_RTOL,
				"margins_zero": not (w[:, : spec.lo].any() or w[:, spec.lo + n :].any())}
			emit(row)
			if not (err_w <= BF16_W_RTOL and err_a <= BF16_W_RTOL and row["margins_zero"]):
				raise AssertionError(f"the bf16 pass A on the padded carry disagrees with its plain version: {row}")
			del cb, qs, qps, w, w_ref
		# Pass A rounded on the flat carry (the full-bf16 flagship's step) through its wrapper, then timed
		# as phase 2 times the float32 pass A.
		scalar = dict(_common.SCALAR_LAUNCHES)
		w, alpha = dia.lanczos_dia_step(bands, offs, q, qp, beta)
		torch.cuda.synchronize()
		vec = _common.SCALAR_LAUNCHES == scalar
		chk = rounded_pass_a_check(torch, dia, w, alpha, bands, offs_host, q, qp, beta)
		if not (chk["ok"] and vec):
			raise AssertionError(f"the rounded bf16 pass A disagrees with its plain version or left its vector path ({vec}) at {nv} x {n}: {chk}")
		record("lanczos_dia_step", f"flat_{nv}x{n}", chk["max_abs_err_unflipped"], chk["tol"],
			lambda: dia._launch_pass_a(lib, bands, offs, q, qp, scal, None, None),
			lambda: dia.lanczos_dia_step_ref(bands, offs_host, q, qp, beta), (2 * nv * n + n_d * n) * 2 + nv * n * 4,
			(2 * n_d + 4) * nv * n, note="no single PyTorch call computes a Lanczos step", prefix="bf16_" if n == N_FLAGSHIP else "bf16_10M_",
			predecessor_ms_quoted=BF16_PREDECESSOR_MS[("lanczos_dia_step", n)], **{k: v for k, v in chk.items() if k not in ("ok", "tol")})
		del w, alpha
		# The round pair on pass A's plain output, on the flat carry (rounded) and the padded one.
		w, alpha = dia.lanczos_dia_step_ref(bands, offs_host, q, qp, beta)
		got = check_round_pair(torch, dia, lib, w, q, alpha, beta, dia.CarrySpec(n, 0, n), f"flat_{nv}x{n}", reps)
		out.setdefault("lanczos_dia_round", {}).update({f"bf16_{'' if n == N_FLAGSHIP else '10M_'}{k}": v for k, v in got.items()})
		if n == N_FLAGSHIP:
			out["lanczos_dia_round"].update(got)
		del w, alpha
		spec = op.carry_spec(nv)
		cb, qs, qps = op._carry_bands(spec), spec.pad(q), spec.pad(qp)
		w, alpha = dia.lanczos_dia_step_ref(cb, offs_host, qs, qps, beta, spec, rounded=False)
		got = check_round_pair(torch, dia, lib, w, qs, alpha, beta, spec, f"padded_{nv}x{n}", reps)
		out["lanczos_dia_round"].update({f"bf16_padded_{tag}_{k}": v for k, v in got.items()})
		del op, bands, q, qp, w, alpha, cb, qs, qps
		torch.cuda.empty_cache()

	# The node-major stencil at the FEM cell (1M × 64, 7 diagonals), beside the float32 instantiation on
	# the same block in float32.
	D = ptt.DIAOperator.from_scipy(fem_laplacian_3d(FEM_SIDE), dtype=bf, device=dev)
	k, n = 64, D.shape[0]
	V = torch.randn((n, k), generator=gen, device=dev).to(bf)
	offs_host = D.offsets_t.cpu()
	got, want = dia.dia_stencil(D.bands, D.offsets_t, V), dia.dia_stencil_ref(D.bands, offs_host, V)
	torch.cuda.synchronize()
	A_csr, refusal = _csr_or_refusal(torch, D.bands, D.offsets, n)
	b32, V32 = D.bands.float(), V.float()
	record("dia_stencil", f"fem_{n}x{k}", float((got.float() - want.float()).abs().max()), _ulp_of_max(want),
		lambda: dia.dia_stencil(D.bands, D.offsets_t, V), lambda: dia.dia_stencil_ref(D.bands, offs_host, V),
		(2 * n * k + D.nnz) * 2, 2 * D.nnz * k, library=(lambda: A_csr @ V) if A_csr is not None else None, want=want, note=refusal,
		float32=lambda: dia.dia_stencil(b32, D.offsets_t, V32), float32_bound_ms=(2 * n * k + D.nnz) * 4 / HBM_BYTES_PER_S * 1e3)
	del D, V, got, want, A_csr, b32, V32

	# The BSR SpMM at phase 7's cell, k = 64.
	S = _bsr_cell(**BSR_CELL)
	B = ptt.BSROperator.from_scipy(S, blocksize=(BSR_CELL["bs"],) * 2, dtype=bf, device=dev)
	V = torch.randn((B.shape[0], k), generator=gen, device=dev).to(bf)
	args = (B.blocks, B.indptr, B.indices, V, B.shape[0])
	got, want = bsr.bsr_spmm(*args), bsr.bsr_spmm_ref(*args)
	torch.cuda.synchronize()
	nnzb, bm, bn = B.blocks.shape
	try:
		B_lib, refusal = torch.sparse_bsr_tensor(B.indptr, B.indices, B.blocks, size=B.pshape), None
	except (RuntimeError, NotImplementedError, TypeError) as e:
		B_lib, refusal = None, f"{type(e).__name__}: {e}"[:300]
	record("bsr_spmm", f"bsr_cell_k{k}", float((got.float() - want.float()).abs().max()), _ulp_of_max(want),
		lambda: bsr.bsr_spmm(*args), lambda: bsr.bsr_spmm_ref(*args), _bytes_bsr(B, k, 2), 2 * nnzb * bm * bn * k,
		library=(lambda: B_lib @ V) if B_lib is not None else None, want=want, note=refusal)
	bo = out["bsr_spmm"]
	bo.update({f"bf16_{key}": v for key, v in _bsr_traffic(B, k, 2, bo["bf16_ms"], bo["bf16_bound_ms"], "bfloat16").items()})
	del B, V, got, want, B_lib
	torch.cuda.empty_cache()
	return out


def _flagship_run(torch, ptt, dev, n: int, dtype, reps: int) -> dict:
	"""The flagship logdet at ``n`` with the operator and the sweep in ``dtype``: :func:`_counted_calls`'
	numbers beside the exact logdet and the error."""
	op = ptt.DIAOperator.from_scipy(build_laplacian(n), dtype=dtype, device=dev)
	M = ptt.MatrixFunction(op, fun="log", deg=DEG, orth=ORTH, reorth_passes=1, dtype=dtype)
	run = _counted_calls(torch, lambda: ptt.hutch(M, batch=PROBES, converge="count", count=PROBES, seed=42), reps)
	est, exact = run.pop("result"), exact_logdet(n)
	return {"dtype": str(dtype).removeprefix("torch."), "estimate": est, "exact": exact, "rel_err": abs(est - exact) / abs(exact),
		"wall_s_median": statistics.median(run["wall_s"]), **run}


def bf16_flagships(torch, ptt, dev) -> tuple:
	"""Phase 24 (b): JAX's full-bf16 SLQ at 500k and 10M beside the float32 flagship, each within 5% of the
	exact logdet; the bf16 sweep runs pass A's bf16 kernel and the round pair once a step each (pass B,
	a float32 pass, never) and no stencil; at 10M its peak memory is below the float32 flagship's. The
	wall and peak ratios of each size go out on a line of their own. Returns the bf16 launches of both
	calls and those of the 500k call alone."""
	total, first = {}, None
	for n, reps in ((N_FLAGSHIP, 5), (N_LARGE, 2)):
		f32 = _flagship_run(torch, ptt, dev, n, torch.float32, reps)
		torch.cuda.empty_cache()
		b16 = _flagship_run(torch, ptt, dev, n, torch.bfloat16, reps)
		torch.cuda.empty_cache()
		row = {"phase": "bf16_flagship", "n": n, "deg": DEG, "probes": PROBES, "bf16": b16, "float32": f32,
			"wall_ratio": b16["wall_s_median"] / f32["wall_s_median"],
			"peak_ratio": b16["max_memory_allocated_bytes"] / f32["max_memory_allocated_bytes"]}
		emit(row)
		emit({"phase": "bf16_flagship_ratios", "n": n, "wall_ratio": row["wall_ratio"], "peak_ratio": row["peak_ratio"],
			"bf16_wall_s_median": b16["wall_s_median"], "float32_wall_s_median": f32["wall_s_median"],
			"bf16_peak_bytes": b16["max_memory_allocated_bytes"], "float32_peak_bytes": f32["max_memory_allocated_bytes"]})
		want = {"lanczos_dia_step": DEG, "lanczos_dia_round": DEG, "lanczos_dia_residual": 0, "dia_stencil_t": 0}
		got = {k: b16["launches"][k] for k in want}
		bf16_got = {k: b16["bf16_launches"][k] for k in ("lanczos_dia_step", "lanczos_dia_round")}
		bf16_want = {"lanczos_dia_step": DEG, "lanczos_dia_round": DEG}
		if not (b16["rel_err"] < 0.05 and f32["rel_err"] < 0.05) or got != want or bf16_got != bf16_want:
			raise AssertionError(f"the full-bf16 flagship at n={n} misses the logdet or its launches: {row}")
		if n == N_LARGE and not row["peak_ratio"] < 1:
			raise AssertionError(f"the 10M full-bf16 flagship's peak memory is not below the float32 one's: {row}")
		_add(total, b16["bf16_launches"])
		first = first or dict(b16["bf16_launches"])
	return total, first


def bf16_applies(torch, ptt, dev) -> dict:
	"""Phase 24 (c): the plain trace ``hutch(DIAOperator(L, bf16))`` at 500k through the bf16 probe-major
	stencil, against the float32 trace on the same probes (within 5σ of 3n): each bf16 quadratic form is
	rounded to bf16, as in the JAX package, so the two agree within one bf16 ulp of 3n; the bf16 FEM
	operator's node-major apply ``op.matmat(V)`` of a 1M × 64 block (the bf16 node-major stencil, against
	the float32 operator's apply); and the bf16 BSR trace on phase 7's cell against the float32 one on the
	same probes (within 1e-2). Returns the bf16 launches of these calls."""
	from benchmarks.matrices import fem_laplacian_3d
	from primate_tpu_torch.ops import _common

	bf, total = torch.bfloat16, {}
	n = N_FLAGSHIP
	L = build_laplacian(n)
	rows = {}
	for dt in (torch.float32, bf):
		op = ptt.DIAOperator.from_scipy(L, dtype=dt, device=dev)
		_common.reset_launches()
		est, res = ptt.hutch(op, batch=PROBES, pdf=_rademacher_f32, converge="count", count=PROBES, seed=7, full=True)
		rows[str(dt).removeprefix("torch.")] = {"estimate": est, "sigma": float(np.sqrt(res.estimator.converged_variance / res.nit)),
			"launches": dict(_common.LAUNCHES), "bf16_launches": dict(_common.BF16_LAUNCHES)}
		del op
	b16, f32 = rows["bfloat16"], rows["float32"]
	ulp = 2.0 ** (np.floor(np.log2(3.0 * n)) - 7)
	row = {"phase": "bf16_plain_trace", "n": n, "exact": 3.0 * n, "bf16_ulp_of_exact": ulp, "diff_vs_float32": abs(b16["estimate"] - f32["estimate"]),
		**rows}
	emit(row)
	if not (abs(f32["estimate"] - 3.0 * n) <= 5 * f32["sigma"] and row["diff_vs_float32"] <= ulp) or b16["bf16_launches"]["dia_stencil_t"] < 1:
		raise AssertionError(f"the bf16 plain trace is off or did not launch the bf16 stencil: {row}")
	_add(total, b16["bf16_launches"])

	A = fem_laplacian_3d(FEM_SIDE)
	D16, D32 = (ptt.DIAOperator.from_scipy(A, dtype=dt, device=dev) for dt in (bf, torch.float32))
	gen = torch.Generator(device=dev)
	gen.manual_seed(241)
	V = torch.randn((A.shape[0], PROBES), generator=gen, device=dev).to(bf)
	_common.reset_launches()
	got = D16.matmat(V)
	torch.cuda.synchronize()
	counts, bcounts = dict(_common.LAUNCHES), dict(_common.BF16_LAUNCHES)
	want = D32.matmat(V.float())
	err = float((got.float() - want).abs().max()) / float(want.abs().max())
	row = {"phase": "bf16_fem_apply", "n": A.shape[0], "k": PROBES, "rel_err_vs_float32": err, "launches": counts, "bf16_launches": bcounts}
	emit(row)
	# The bf16 bands of the FEM stencil (6 and -1) are exact and the output is rounded once: half a bf16
	# ulp of each entry, within 2^-8 of the largest.
	if not (err <= 2.0**-8 and bcounts["dia_stencil"] == 1 and got.dtype == bf):
		raise AssertionError(f"the bf16 FEM apply is off or did not launch the bf16 node-major stencil once: {row}")
	_add(total, bcounts)
	del D16, D32, V, got, want

	S = _bsr_cell(**BSR_CELL)
	rows = {}
	for dt in (torch.float32, bf):
		B = ptt.BSROperator.from_scipy(S, blocksize=(BSR_CELL["bs"],) * 2, dtype=dt, device=dev)
		rows[str(dt).removeprefix("torch.")] = _counted_calls(
			torch, lambda: ptt.hutch(B, batch=PROBES, pdf=_rademacher_f32, converge="count", count=4 * PROBES, seed=7), reps=2
		)
		del B
		torch.cuda.empty_cache()
	tr = float(S.diagonal().astype(np.float64).sum())
	b16, f32 = rows["bfloat16"], rows["float32"]
	rel = abs(b16["result"] - f32["result"]) / abs(f32["result"])
	row = {"phase": "bf16_bsr_trace", "n": S.shape[0], "trace": tr, "rel_diff_vs_float32": rel, "rel_err_vs_trace": abs(b16["result"] - tr) / tr, **rows}
	emit(row)
	if not rel <= BF16_BSR_TOL or b16["bf16_launches"]["bsr_spmm"] != 4:
		raise AssertionError(f"the bf16 BSR trace is off or did not launch the bf16 bsr_spmm once a batch: {row}")
	_add(total, b16["bf16_launches"])
	return total


def _counted_calls(torch, fn, reps: int) -> dict:
	"""The counted first call of ``fn`` (its result, launches, bf16 launches and synced wall), then ``reps`` synced walls,
	and the peak memory."""
	from primate_tpu_torch.ops import _common

	torch.cuda.synchronize()
	torch.cuda.reset_peak_memory_stats()
	_common.reset_launches()
	t0 = time.perf_counter()
	result = fn()
	torch.cuda.synchronize()
	first = time.perf_counter() - t0
	launches, bf16 = dict(_common.LAUNCHES), dict(_common.BF16_LAUNCHES)
	times = []
	for _ in range(reps):
		t0 = time.perf_counter()
		fn()
		torch.cuda.synchronize()
		times.append(time.perf_counter() - t0)
	return {"result": result, "first_s": first, "wall_s": times, "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
		"launches": launches, "bf16_launches": bf16}


def bf16_sharded_one_rank(torch, ptt, dev) -> dict:
	"""Phase 24 (d): the full-bf16 flagship at 10M through ``shard_operator(DIAOperator(L, bf16))`` on one NCCL
	rank (pass A's bf16 kernel on the padded carry after the halo exchange, the stencil rounded as JAX's
	sharded apply rounds it, α all-reduced; the round pair with Σv² all-reduced between its two launches,
	B2 finishing the step: no advance kernel) against the unsharded bf16 operator on the same probes: the estimates within
	1e-3, the sharded one within 5% of the exact logdet. Returns its bf16 launches."""
	from primate_tpu_torch.parallel import initialize_distributed, make_mesh, shard_operator

	bf = torch.bfloat16
	torch.cuda.set_device(dev)
	initialize_distributed("nccl", init_method=f"tcp://localhost:{_free_port()}", world_size=1, rank=0)
	op = ptt.DIAOperator.from_scipy(build_laplacian(N_LARGE), dtype=bf, device=dev)
	sop = shard_operator(op, make_mesh((1, 1), ("op", "probe")))
	rows = {}
	for name, o in (("unsharded", op), ("sharded", sop)):
		M = ptt.MatrixFunction(o, fun="log", deg=DEG, orth=ORTH, reorth_passes=1, dtype=bf)
		rows[name] = _counted_calls(torch, lambda: ptt.hutch(M, batch=PROBES, converge="count", count=PROBES, seed=42), reps=1)
		del M
		torch.cuda.empty_cache()
	exact = exact_logdet(N_LARGE)
	diff = abs(rows["sharded"]["result"] - rows["unsharded"]["result"]) / abs(rows["unsharded"]["result"])
	row = {"phase": "bf16_sharded_flagship", "world": 1, "backend": "nccl", "n": N_LARGE, "deg": DEG, "probes": PROBES, "exact": exact,
		"estimate_rel_diff": diff, "rel_err": abs(rows["sharded"]["result"] - exact) / abs(exact), **rows}
	emit(row)
	got = {k: rows["sharded"]["bf16_launches"][k] for k in ("lanczos_dia_step", "lanczos_dia_round", "dia_stencil_t")}
	got["lanczos_dia_advance"] = rows["sharded"]["launches"]["lanczos_dia_advance"]
	want = {"lanczos_dia_step": DEG, "lanczos_dia_round": DEG, "dia_stencil_t": 0, "lanczos_dia_advance": 0}
	ADVANCE_A_SWEEP[f"sharded_{N_LARGE}_bfloat16"] = got["lanczos_dia_advance"]
	if not (diff < BF16_SHARD_TOL and row["rel_err"] < 0.05) or got != want:
		raise AssertionError(f"the sharded bf16 flagship disagrees with the unsharded one, or its launches {got} are off: {row}")
	del op, sop
	torch.distributed.destroy_process_group()
	torch.cuda.empty_cache()
	return rows["sharded"]["bf16_launches"]


def bf16_sharded_two_ranks(torch) -> dict:
	"""Phase 24 (e): the full-bf16 flagship at SHARD_N through the halo DIA operator on two gloo ranks,
	both on cuda:0 (subprocesses, ``--sharded-rank ... bfloat16``): both ranks' estimates equal bit for
	bit and within 5% of the exact logdet, each rank's bf16 pass A and round pair launched. Returns their
	bf16 launches."""
	(r0,), (r1,) = _run_ranks(2, "bfloat16")
	exact = exact_logdet(SHARD_N)
	row = {"phase": "bf16_sharded_two_ranks", "world": 2, "backend": "gloo", "n": SHARD_N, "mesh": r0["mesh"], "comm": r0["comm"],
		"estimates": [r0["estimate"], r1["estimate"]], "exact": exact, "rel_err": abs(r0["estimate"] - exact) / abs(exact),
		"wall_s": [r0["wall_s"], r1["wall_s"]], "launches": [r0["launches"], r1["launches"]], "bf16_launches": [r0["bf16_launches"], r1["bf16_launches"]]}
	emit(row)
	if r0["estimate_hex"] != r1["estimate_hex"] or not row["rel_err"] < 0.05:
		raise AssertionError(f"the two bf16 ranks disagree or miss the logdet: {row}")
	if min(r["bf16_launches"][k] for r in (r0, r1) for k in ("lanczos_dia_step", "lanczos_dia_round")) < 1 or max(
		r["launches"]["dia_stencil_t"] for r in (r0, r1)
	) > 0:
		raise AssertionError(f"the bf16 pass A or the round pair did not launch on every rank (or the plain step ran): {row}")
	ADVANCE_A_SWEEP[f"gloo_{SHARD_N}_bfloat16"] = [r["launches"]["lanczos_dia_advance"] for r in (r0, r1)]
	if ADVANCE_A_SWEEP[f"gloo_{SHARD_N}_bfloat16"] != [0, 0]:
		raise AssertionError(f"a bf16 gloo rank launched the advance kernel (B2 finishes its steps): {row}")
	total = {}
	for r in (r0, r1):
		_add(total, r["bf16_launches"])
	return total


# Phase 26: what the port lacked of the JAX package. (a) The degeneracy-stable derivative of the Gauss
# quadrature on a batch of molecules: C12["chains"] disjoint chains of C12["atoms"] rows, tridiag(−1, 3, −1)
# with the coupling cut between chains (n = 1,000,000), float32 bands, Σ MatrixFunction(op, "log", deg 20,
# orth 0).quad(V) on 64 Rademacher probes (each breaks down at step 10) and its gradient to the bands:
# ⟨∂bands, bands⟩ = Σ‖v‖² = probes·n within C12_HOMOG_TOL (relative; log is homogeneous), and two seeded
# symmetric block-preserving directional derivatives within C12_DD_TOL (relative) of the float64 closed
# form. (b) Every operator kind × every estimator entry point (tests/test_torch_matrix_coverage.py at a
# card's width): tridiag(−1, 3, −1) at COV_N as DIA, CSR, COO, BSR 8×8, a FunctionOperator around the DIA
# apply, AffineOperator(DIA, t=0) and MatrixFunction(DIA, "identity", deg=2), and at COV_DENSE_N as a
# tensor and a DenseOperator; traces within COV_TRACE_TOL of 3n, diagonals within COV_DIAG_TOL (relative
# L2), solve's residual below its rtol, Lanczos finite, and the formats that draw the same probes
# within COV_AGREE_TOL of each other. (c) The CPU edge cases (tests/torch_cases.py's EDGE_CASES) with their
# tensors on the card, and DIA operators of 1 and 3 rows through the stencils and the step passes, each
# kernel held to its plain version there.
C12 = dict(chains=100_000, atoms=10, probes=64, deg=20, seed=26)
C12_HOMOG_TOL, C12_DD_TOL = 1e-4, 1e-3
COV_N, COV_DENSE_N, COV_SEED = 1_048_576, 8192, 26
COV_TRACE_TOL, COV_DIAG_TOL, COV_AGREE_TOL, COV_SOLVE_RTOL = 1e-3, 0.1, 1e-5, 1e-5
# Kernels each format must launch in (b), and the family it may launch from: DIA-backed kinds run the DIA
# kernels (the DIA operator the step passes too, its Lanczos sweeps at orth 0; the identity MatrixFunction,
# at orth 3, pass A and the CGS window's chain), BSR runs bsr_spmm, CSR and COO (cuSPARSE) and the dense kinds
# (cuBLAS) none.
_DIA_FAMILY = ("dia_stencil_t", "dia_stencil", "lanczos_dia_step", "lanczos_dia_residual")
COV_KERNELS = {
	"dia": (_DIA_FAMILY, _DIA_FAMILY),
	"function": (("dia_stencil",), _DIA_FAMILY),
	"affine": (("dia_stencil_t",), _DIA_FAMILY),
	"matrix_function": (("lanczos_dia_step", "cgs_window"), _DIA_FAMILY + ("cgs_window",)),
	"bsr": (("bsr_spmm",), ("bsr_spmm",)),
	"csr": ((), ()), "coo": ((), ()), "tensor": ((), ()), "dense_op": ((), ()),
}


def _cases():
	"""``tests/torch_cases.py``: the chains and the edge cases that the CPU suites hold, run here on the card."""
	sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
	import torch_cases

	return torch_cases


def _stencil_pair_check(torch, dia, bands, offsets, X, tol: float, label: str) -> dict:
	"""``dia_stencil_t`` on ``X (k, n)`` and ``dia_stencil`` on ``Xᵀ`` against their plain versions; not counted."""
	from primate_tpu_torch.ops import _common

	saved = dict(_common.LAUNCHES)
	offs = torch.tensor(offsets, dtype=torch.int64, device=bands.device)
	errs = {}
	for name, got, want in (
		("dia_stencil_t", dia.dia_stencil_t(bands, offs, X), dia.dia_stencil_t_ref(bands, offs.cpu(), X)),
		("dia_stencil", dia.dia_stencil(bands, offs, X.T.contiguous()), dia.dia_stencil_ref(bands, offs.cpu(), X.T.contiguous())),
	):
		errs[name] = float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)
	_common.LAUNCHES.update(saved)
	if not all(e <= tol for e in errs.values()):
		raise AssertionError(f"{label}: a stencil disagrees with its plain version: {errs}")
	return errs


def quad_grad_chains(torch, ptt, dev) -> dict:
	"""Phase 26 (a). Returns the kernels' forward and backward launches."""
	from primate_tpu_torch.ops import dia
	from primate_tpu_torch.ops.autograd import dia_adjoint

	chains, atoms, p, deg = C12["chains"], C12["atoms"], C12["probes"], C12["deg"]
	n = chains * atoms
	offsets = (-1, 0, 1)
	cases = _cases()
	bands = torch.tensor(cases.chain_bands(chains, atoms), dtype=torch.float32, device=dev)
	gen = torch.Generator(device=dev)
	gen.manual_seed(C12["seed"])
	V = torch.randint(0, 2, (n, p), generator=gen, device=dev).to(torch.float32) * 2 - 1
	# The kernels at this path's shapes (forward bands, and the adjoint bands of the backward).
	errs = _stencil_pair_check(torch, dia, bands, offsets, V.T.contiguous(), STENCIL_TOL["float32"], "chains")
	adj, adj_offsets = dia_adjoint(bands, offsets)
	errs_adj = _stencil_pair_check(torch, dia, adj, adj_offsets, V.T.contiguous(), STENCIL_TOL["float32"], "chains adjoint")
	# Every probe breaks down at step 10 (β_10 below the sweep's residual tolerance, √n·1e-8), none before.
	_, betas = ptt.lanczos(ptt.DIAOperator(bands, offsets, (n, n)), v0=V, deg=deg, orth=0)
	tol = n**0.5 * 1e-8
	broke = (float(betas[atoms - 1].max()), float(betas[: atoms - 1].min()))
	if not (broke[0] < tol < broke[1]):
		raise AssertionError(f"chains: the probes do not break down at step {atoms}: max β_{atoms} {broke[0]}, min before {broke[1]}")
	leaf = bands.clone().requires_grad_(True)

	def F():
		op = ptt.DIAOperator(leaf, offsets, (n, n))
		return ptt.MatrixFunction(op, "log", deg=deg, orth=0).quad(V).sum()

	res = _grad_of(torch, F, leaf)
	g = res["grad"]
	finite = bool(torch.isfinite(g).all())
	g64 = g.double()
	homog = float(torch.sum(g64 * bands.double()))
	want_h = float(p * n)
	Vb = V.double().reshape(chains, atoms, p)
	S = (Vb @ Vb.mT).cpu().numpy()
	del Vb
	gh = g64.cpu().numpy()
	dds = []
	for s in (1, 2):
		H = cases.chain_direction(chains, atoms, C12["seed"] + s)
		got, want = float(np.sum(gh * H)), cases.chain_log_derivative(atoms, H, S)
		dds.append({"got": got, "closed_form_f64": want, "rel_err": abs(got - want) / abs(want)})
	row = {"phase": "quad_grad_chains", "n": n, "chains": chains, "atoms": atoms, "probes": p, "deg": deg, "orth": 0,
		"value": res["est"], "grad_finite": finite, "homogeneity": homog, "homogeneity_want": want_h,
		"homogeneity_rel_err": abs(homog - want_h) / want_h, "homogeneity_tol": C12_HOMOG_TOL, "directional": dds,
		"dd_tol": C12_DD_TOL, "breakdown_beta_max": broke[0], "beta_min_before": broke[1], "forward_s": res["forward_s"], "backward_s": res["backward_s"],
		"max_memory_allocated_bytes": res["peak_bytes"], "forward_launches": res["forward"],
		"backward_launches": res["backward"], "stencil_rel_err": errs, "adjoint_stencil_rel_err": errs_adj}
	emit(row)
	if not finite:
		raise AssertionError(f"the quadrature's gradient on the disjoint chains is not finite: {row}")
	if not (row["homogeneity_rel_err"] <= C12_HOMOG_TOL and all(d["rel_err"] <= C12_DD_TOL for d in dds)):
		raise AssertionError(f"the quadrature's gradient on the disjoint chains is off its closed form: {row}")
	fwd, bwd = res["forward"], res["backward"]
	if (fwd["dia_stencil_t"], bwd["dia_stencil_t"]) != (deg, deg - 1):
		raise AssertionError(f"dia_stencil_t {fwd['dia_stencil_t']} forward, {bwd['dia_stencil_t']} backward; expected {deg}, {deg - 1}")
	if fwd["lanczos_dia_step"] + fwd["lanczos_dia_residual"] + bwd["lanczos_dia_step"] + bwd["lanczos_dia_residual"]:
		raise AssertionError(f"a differentiated sweep launched a step kernel: {fwd} {bwd}")
	del leaf, g, g64, V, S
	return {"forward": fwd, "backward": bwd}


def _cov_budget(n: int) -> int:
	"""Probes for an estimate within 1e-3 of tr = 3n at 5σ: a Rademacher quadratic form of tridiag(−1, 3, −1)
	has variance about 4n, so 2^26 / n probes (at least phase 7's 256). XDiag takes 8 times as many (at most
	2n): on this flat spectrum phase 7's m = 256 leaves 0.13 of the diagonal (relative L2) at 1M rows."""
	return max(256, (1 << 26) // n)


def _cov_calls(torch, ptt, op, n: int, dev) -> dict:
	"""The seven entry points on ``op``, each checked against the closed form; their results."""
	k = _cov_budget(n)
	g = torch.Generator(device=dev)
	g.manual_seed(COV_SEED)
	V0 = torch.randint(0, 2, (n, 64), generator=g, device=dev).to(torch.float32) * 2 - 1
	y = torch.randn(n, generator=g, device=dev, dtype=torch.float32)
	calls = {
		"hutch": lambda: float(ptt.hutch(op, batch=64, converge="count", count=k, seed=COV_SEED)),
		"hutchpp": lambda: float(ptt.hutchpp(op, m=max(240, k), seed=COV_SEED)),
		"xtrace": lambda: float(ptt.xtrace(op, batch=64, converge="count", count=k, seed=COV_SEED)),
		"diag": lambda: torch.as_tensor(ptt.diag(op, batch=64, converge="count", count=k // 64, seed=COV_SEED)),
		"xdiag": lambda: torch.as_tensor(ptt.xdiag(op, m=min(8 * k, 2 * n), seed=COV_SEED)),
		"lanczos": lambda: ptt.lanczos(op, v0=V0, deg=20, orth=0),
		"solve": lambda: ptt.solve(op, y, rtol=COV_SOLVE_RTOL),
	}
	out = {}
	for name, fn in calls.items():
		t0 = time.perf_counter()
		r = fn()
		torch.cuda.synchronize()
		wall = time.perf_counter() - t0
		if name in ("hutch", "hutchpp", "xtrace"):
			err = abs(r - 3.0 * n) / (3.0 * n)
			ok, out[name] = err <= COV_TRACE_TOL, {"estimate": r, "rel_err": err}
		elif name in ("diag", "xdiag"):
			d = r.to(device="cpu", dtype=torch.float64)
			err = float(torch.linalg.vector_norm(d - 3.0) / (3.0 * n**0.5))
			ok, out[name] = bool(torch.isfinite(d).all()) and d.shape == (n,) and err <= COV_DIAG_TOL, {"rel_l2_err": err, "vec": d}
		elif name == "lanczos":
			a, b = r
			ok, out[name] = bool(torch.isfinite(a).all() and torch.isfinite(b).all()) and tuple(a.shape) == (20, 64), {}
		else:
			x = r.double()
			res = float(torch.linalg.vector_norm(y.double() - _tridiag_apply64(x)) / torch.linalg.vector_norm(y.double()))
			ok, out[name] = res <= COV_SOLVE_RTOL, {"rel_residual": res, "rtol": COV_SOLVE_RTOL}
		out[name]["wall_s"] = wall
		if not ok:
			raise AssertionError(f"coverage: {name} is off: { {k2: v for k2, v in out[name].items() if k2 != 'vec'} }")
	return out


def _tridiag_apply64(x):
	"""``L x`` for tridiag(−1, 3, −1), in ``x``'s dtype, independent of the operator under test."""
	Lx = 3.0 * x
	Lx[1:] -= x[:-1]
	Lx[:-1] -= x[1:]
	return Lx


def coverage(torch, ptt, dev) -> dict:
	"""Phase 26 (b). Returns the kernels' launches over the phase."""
	import scipy.sparse as sps

	from primate_tpu_torch.operators import AffineOperator
	from primate_tpu_torch.ops import _common

	L = build_laplacian(COV_N)
	t0 = time.perf_counter()
	dia_op = ptt.DIAOperator.from_scipy(L, dtype=torch.float32, device=dev)
	Ld = sps.diags([-np.ones(COV_DENSE_N - 1), 3.0 * np.ones(COV_DENSE_N), -np.ones(COV_DENSE_N - 1)], [-1, 0, 1])
	T = torch.tensor(Ld.toarray(), dtype=torch.float32, device=dev)
	kinds = {
		"dia": lambda: dia_op,
		"csr": lambda: ptt.CSROperator.from_scipy(L, dtype=torch.float32, device=dev),
		"coo": lambda: ptt.COOOperator.from_scipy(L.tocoo(), dtype=torch.float32, device=dev),
		"bsr": lambda: ptt.BSROperator.from_scipy(L, blocksize=(8, 8), dtype=torch.float32, device=dev),
		"function": lambda: ptt.FunctionOperator(dia_op.matmat, (COV_N, COV_N), dtype=torch.float32, device=dev),
		"affine": lambda: AffineOperator(dia_op, t=0.0, device=dev),
		"matrix_function": lambda: ptt.MatrixFunction(dia_op, "identity", deg=2, device=dev),
		"tensor": lambda: T,
		"dense_op": lambda: ptt.DenseOperator(T, device=dev),
	}
	total, results = {}, {}
	for kind, make in kinds.items():
		op = make()
		n = COV_DENSE_N if kind in ("tensor", "dense_op") else COV_N
		torch.cuda.synchronize()
		_common.reset_launches()
		t1 = time.perf_counter()
		res = _cov_calls(torch, ptt, op, n, dev)
		torch.cuda.synchronize()
		wall = time.perf_counter() - t1
		counts = dict(_common.LAUNCHES)
		_add(total, counts)
		results[kind] = res
		emit({"phase": "coverage", "kind": kind, "n": n, "wall_s": wall, "launches": counts,
			"calls": {c: {k2: v for k2, v in r.items() if k2 != "vec"} for c, r in res.items()}})
		need, family = COV_KERNELS[kind]
		missing = [k2 for k2 in need if counts.get(k2, 0) < 1]
		foreign = {k2: c for k2, c in counts.items() if c and k2 not in family}
		if missing or foreign:
			raise AssertionError(f"coverage: {kind} launched {counts}; expected {need or 'no kernel'} from {family}")
		del op
	# The formats that draw the same probes (same n, dtype and device) agree.
	agree = {}
	for group in (("dia", "csr", "coo", "bsr", "function", "affine", "matrix_function"), ("tensor", "dense_op")):
		ref = results[group[0]]
		for kind in group[1:]:
			for name in ("hutch", "hutchpp", "xtrace"):
				e = abs(results[kind][name]["estimate"] - ref[name]["estimate"]) / abs(ref[name]["estimate"])
				agree[f"{kind}/{name}"] = e
			for name in ("diag", "xdiag"):
				a, b = results[kind][name]["vec"], ref[name]["vec"]
				agree[f"{kind}/{name}"] = float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))
	worst = max(agree, key=agree.get)
	emit({"phase": "coverage", "kind": "agreement", "tol": COV_AGREE_TOL, "worst": worst, "worst_rel_err": agree[worst],
		"rel_err": agree, "launches": total, "seconds": time.perf_counter() - t0})
	if agree[worst] > COV_AGREE_TOL:
		raise AssertionError(f"coverage: formats on the same probes disagree: {worst} {agree[worst]}")
	return total


def edge_cases(torch, ptt, dev) -> dict:
	"""Phase 26 (c): ``tests/torch_cases.py``'s ``EDGE_CASES`` with their tensors on ``dev``, held to the limits
	that the CPU test holds them to; at the DIA operators of 1 and 3 rows, the stencils and the step passes
	(not counted) held to their plain versions first. Returns the kernels' launches over the phase."""
	from primate_tpu_torch.ops import _common, dia

	cases = _cases()
	f64 = torch.float64
	torch.cuda.synchronize()
	_common.reset_launches()
	t0 = time.perf_counter()
	for n in (1, 3):
		A, _ = cases.tiny_dia(n)
		op = ptt.DIAOperator.from_scipy(A, dtype=f64, device=dev)
		X = torch.tensor(np.random.default_rng(n).normal(size=(4, n)), dtype=f64, device=dev)
		errs = _stencil_pair_check(torch, dia, op.bands, op.offsets, X, STENCIL_TOL["float64"], f"dia n={n}")
		saved = dict(_common.LAUNCHES)
		st, st_ref = dia.lanczos_state(4, f64, dev), dia.lanczos_state(4, f64, dev)
		q = X / torch.linalg.vector_norm(X, dim=1, keepdim=True)
		offs = torch.tensor(op.offsets, dtype=torch.int64, device=dev)
		ab, ab_ref = torch.empty((2, 4), dtype=f64, device=dev), torch.empty((2, 4), dtype=f64, device=dev)
		w = dia.lanczos_dia_sweep_step(op.bands, offs, q, torch.zeros_like(q), st, ab[0], ab[1], 1e-8)
		w_ref = dia.lanczos_sweep_step_ref(lambda x: dia.dia_stencil_t_ref(op.bands, offs.cpu(), x), q, torch.zeros_like(q),
			st_ref, ab_ref[0], ab_ref[1], 1e-8)
		_common.LAUNCHES.update(saved)
		errs["step_w"] = float((w - w_ref).abs().max())
		errs["step_alpha_beta"] = float((ab - ab_ref).abs().max())
		emit({"phase": "edge_case", "case": f"tiny_dia_kernels_{n}", "kernel_abs_err": errs})
		if not (errs["step_w"] <= 1e-12 and errs["step_alpha_beta"] <= 1e-12):
			raise AssertionError(f"dia n={n}: the step passes disagree with their plain version: {errs}")
	for name, case in cases.EDGE_CASES.items():
		emit({"phase": "edge_case", "case": name, "ok": True, **case(dev)})
	torch.cuda.synchronize()
	counts = dict(_common.LAUNCHES)
	emit({"phase": "edge_case", "case": "launches", "cases": len(cases.EDGE_CASES), "launches": counts, "seconds": time.perf_counter() - t0})
	for k in ("dia_stencil_t", "dia_stencil", "lanczos_dia_step", "lanczos_dia_residual"):
		if counts.get(k, 0) < 1:
			raise AssertionError(f"the edge cases launched no {k}: {counts}")
	return counts


def port_gaps(torch, ptt, dev) -> dict:
	"""Phase 26: (a)-(c) above, each kernel's launches over the phase by part (``coverage_launches``)."""
	t0 = time.perf_counter()
	grads = quad_grad_chains(torch, ptt, dev)
	torch.cuda.empty_cache()
	cov = coverage(torch, ptt, dev)
	torch.cuda.empty_cache()
	edge = edge_cases(torch, ptt, dev)
	torch.cuda.empty_cache()
	emit({"phase": "port_gaps_done", "seconds": time.perf_counter() - t0})
	return {k: {"coverage_launches": {"quad_grad_forward": grads["forward"].get(k, 0), "quad_grad_backward": grads["backward"].get(k, 0),
		"coverage": cov.get(k, 0), "edge_cases": edge.get(k, 0)}} for k in KERNELS}


CONTRACT_DENSE_N = 8192  # phase 27 (d): the dense pentadiagonal matrix
CONTRACT_SAMPLE_RTOL, CONTRACT_VAR_RTOL, CONTRACT_SMOOTHSTEP_TOL = 1e-6, 1e-6, 0.01
# Phase 27 (c): a float32 evaluation against float64 numpy on the same nodes, within this many float32 ulps of the
# largest value.
CONTRACT_ULPS = 64
CONTRACT_SPECIAL = {"softsign": dict(q=3), "smoothstep": dict(a=-0.2, b=0.3, deg=5), "exp": dict(t=-0.5), "step": dict(c=0.1)}


def _counted(torch, fn) -> tuple:
	"""One call of ``fn``, its launches counted from zero: (result, launches, synced seconds)."""
	c = _counted_calls(torch, fn, 0)
	return c["result"], c["launches"], c["first_s"]


def _contract_check(ok: bool, row: dict) -> None:
	emit(row)
	if not ok:
		raise AssertionError(f"contract: {row}")


def _contract_sketches(torch, ptt, dev, total: dict) -> None:
	"""Phase 27 (a): the sketches' records on phase 7's BSR cell (``samples``, unpacking)."""
	S = _bsr_cell(**BSR_CELL)
	op = ptt.BSROperator.from_scipy(S, blocksize=(BSR_CELL["bs"], BSR_CELL["bs"]), dtype=torch.float32, device=dev)
	tr = float(S.diagonal().astype(np.float64).sum())
	# Sample counts as tests/test_torch_contract.py pins them in both packages: Hutch++ 2·nb, XNysTrace m.
	for name, m, want_len in (("hutchpp", 240, 480), ("xnystrace", 720, 720)):
		(est, res), counts, wall = _counted(torch, lambda: getattr(ptt, name)(op, m=m, seed=7, full=True))
		_, _, e, _, nit, info = res
		row = {"phase": "contract", "part": "sketch_record", "call": name, "m": m, "samples": len(res.samples),
			"samples_want": want_len, "samples_in_info": "samples" in info, "unpacked_estimate": e, "nit": nit,
			"rel_err": abs(est - tr) / tr, "rel_err_tol": TRACE_TOL, "wall_s": wall, "launches": counts}
		ok = len(res.samples) == want_len and "samples" not in info and e == est and row["rel_err"] < TRACE_TOL
		if name == "xnystrace":
			mean = float(np.mean(res.samples.astype(np.float64)))
			row.update({"samples_mean_rel_err": abs(mean - est) / abs(est), "samples_mean_rel_tol": CONTRACT_SAMPLE_RTOL,
				"converged_variance_tracked": res.estimator.converged_variance is not None})
			ok = ok and row["samples_mean_rel_err"] <= CONTRACT_SAMPLE_RTOL and row["converged_variance_tracked"]
		_add(total, counts)
		_contract_check(ok and counts["bsr_spmm"] == BSR_APPLIES[name], row)


def _contract_diag(torch, ptt, dev, total: dict) -> None:
	"""Phase 27 (b): ``diag``'s record on phase 8's FEM cell: the estimator the callback sees, the recorded
	values where JAX keeps them, and ``resume`` from that record."""
	from benchmarks.matrices import fem_laplacian_3d

	A = fem_laplacian_3d(FEM_SIDE)
	n = A.shape[0]
	op = ptt.DIAOperator.from_scipy(A, dtype=torch.float32, device=dev)
	seen = []
	kw = dict(batch=64, converge="count", pdf="rademacher", seed=8)
	(est, res), counts, wall = _counted(torch, lambda: ptt.diag(op, count=256, full=True, callback=lambda r: seen.append(r.estimator), **kw))
	_add(total, counts)
	row = {"phase": "contract", "part": "diag_record", "n": n, "count": 256, "estimator": type(res.estimator).__name__,
		"estimate_equal_bits": bool(np.array_equal(res.estimator.estimate, est)), "callback_estimators": len(seen),
		"callback_estimators_want": 256, "callback_sees_the_estimator": all(e is res.estimator for e in seen),
		"converged_variance": res.estimator.converged_variance, "message": res.message, "info": sorted(res.info),
		"wall_s": wall, "launches": counts}
	_contract_check(isinstance(res.estimator, ptt.MeanEstimator) and row["estimate_equal_bits"] and len(seen) == 256
		and row["callback_sees_the_estimator"] and row["converged_variance"] is None and bool(res.message)
		and row["info"] == ["state"] and counts["dia_stencil_t"] == 256, row)
	(_, rec), counts, wall = _counted(torch, lambda: ptt.diag(op, count=4, full=True, record=True, **kw))
	_add(total, counts)
	(resumed, direct), counts2, wall2 = _counted(torch, lambda: (ptt.diag(op, count=8, resume=rec, **kw), ptt.diag(op, count=8, **kw)))
	_add(total, counts2)
	row = {"phase": "contract", "part": "diag_record_resume", "values": len(rec.estimator.values), "values_want": 4 * n,
		"values_in_info": "values" in rec.info, "resumed_equals_direct_bits": bool(np.array_equal(resumed, direct)),
		"wall_s": [wall, wall2], "launches": [counts, counts2]}
	_contract_check(row["values"] == 4 * n and not row["values_in_info"] and row["resumed_equals_direct_bits"], row)


def _smoothstep_trace(n: int, a: float, b: float) -> float:
	"""``Σ S((λ − a)/(b − a))`` over the eigenvalues ``3 − 2cos(kπ/(n+1))`` of tridiag(−1, 3, −1), S the cubic smoothstep."""
	lam = 3.0 - 2.0 * np.cos(np.arange(1, n + 1) * np.pi / (n + 1))
	y = np.clip((lam - a) / (b - a), 0.0, 1.0)
	return float(np.sum(y * y * (3.0 - 2.0 * y)))


def _contract_special(torch, ptt, dev, total: dict) -> None:
	"""Phase 27 (c): the special functions given their nodes on the card, and a closure of one through SLQ."""
	from primate_tpu_torch import special

	x = torch.linspace(-1.5, 1.5, 1_000_000, dtype=torch.float32, device=dev)
	x64 = x.cpu().numpy().astype(np.float64)
	want64 = {
		"softsign": lambda q: np.sum(np.clip(x64, -1, 1)[:, None] * (1 - np.clip(x64, -1, 1)[:, None] ** 2) ** np.arange(q + 1)
			* np.append([1.0], np.cumprod([(2 * j - 1) / (2 * j) for j in range(1, q + 1)])), axis=-1),
		"smoothstep": lambda a, b, deg: (lambda y: y**3 * (10 - 15 * y + 6 * y * y))(np.clip((x64 - a) / (b - a), 0, 1)),
		"exp": lambda t: np.exp(t * x64),
		"step": lambda c: np.where(x64 < c, 0.0, 1.0),
	}
	for name, kw in CONTRACT_SPECIAL.items():
		f = getattr(special, name)
		got = f(x, **kw)
		want = want64[name](**kw)
		err = float(np.max(np.abs(got.double().cpu().numpy() - want)))
		tol = CONTRACT_ULPS * float(np.finfo(np.float32).eps) * max(1.0, float(np.max(np.abs(want))))
		row = {"phase": "contract", "part": "special", "function": name, "params": kw, "n": x.numel(),
			"equals_closure_bits": bool(torch.equal(got, f(**kw)(x))), "device": str(got.device), "dtype": str(got.dtype),
			"max_abs_err_vs_float64": err, "tol": tol}
		_contract_check(row["equals_closure_bits"] and got.device == x.device and got.dtype == torch.float32 and err <= tol, row)
	n = N_FLAGSHIP
	op = ptt.DIAOperator.from_scipy(build_laplacian(n), dtype=torch.float32, device=dev)
	M = ptt.MatrixFunction(op, special.smoothstep(a=0.5, b=2.0), deg=DEG, orth=ORTH, dtype=torch.float32)
	est, counts, wall = _counted(torch, lambda: ptt.hutch(M, batch=PROBES, converge="count", count=PROBES, seed=42))
	_add(total, counts)
	exact = _smoothstep_trace(n, 0.5, 2.0)
	row = {"phase": "contract", "part": "smoothstep_slq", "n": n, "estimate": est, "exact": exact,
		"rel_err": abs(est - exact) / exact, "rel_err_tol": CONTRACT_SMOOTHSTEP_TOL, "wall_s": wall, "launches": counts}
	# Two sweeps: hutch sizes a callable's output by one quad of a zero probe (JAX traces it), then estimates.
	_contract_check(row["rel_err"] <= CONTRACT_SMOOTHSTEP_TOL and counts["lanczos_dia_step"] == 2 * DEG
		and counts["lanczos_dia_residual"] == 2 * DEG, row)


def _contract_from_dense(torch, ptt, dev, total: dict) -> None:
	"""Phase 27 (d): ``DIAOperator.from_dense`` of a dense pentadiagonal SPD matrix against ``from_scipy``."""
	import scipy.sparse as sps

	n = CONTRACT_DENSE_N
	diags = {0: 5.0, 1: -1.0, -1: -1.0, 2: -0.5, -2: -0.5}
	A = sps.diags([np.full(n - abs(o), v, np.float32) for o, v in diags.items()], list(diags), shape=(n, n)).astype(np.float32)
	t0 = time.perf_counter()
	D = A.toarray()
	dense_op = ptt.DIAOperator.from_dense(D, dtype=torch.float32, device=dev)
	t_dense = time.perf_counter() - t0
	sparse_op = ptt.DIAOperator.from_scipy(A.tocsr(), dtype=torch.float32, device=dev)
	del D
	same = dense_op.offsets == sparse_op.offsets and torch.equal(dense_op.bands, sparse_op.bands)
	ests, launches = [], []
	for op in (dense_op, sparse_op):
		M = ptt.MatrixFunction(op, "log", deg=DEG, orth=0, dtype=torch.float32)
		est, counts, _ = _counted(torch, lambda: ptt.hutch(M, batch=PROBES, converge="count", count=PROBES, seed=27))
		_add(total, counts)
		ests.append(est)
		launches.append(counts)
	row = {"phase": "contract", "part": "from_dense", "n": n, "offsets": list(dense_op.offsets), "bands_equal": bool(same),
		"from_dense_s": t_dense, "estimates": ests, "estimates_equal_bits": ests[0] == ests[1], "launches": launches}
	_contract_check(same and ests[0] == ests[1] and all(c["lanczos_dia_step"] == DEG and c["lanczos_dia_residual"] == DEG for c in launches), row)


def _contract_mean_estimator(torch, ptt, dev, total: dict) -> None:
	"""Phase 27 (e): ``MeanEstimator(covariance=...)`` on the card, fed the flagship's 64 per-probe samples."""
	op = ptt.DIAOperator.from_scipy(build_laplacian(N_FLAGSHIP), dtype=torch.float32, device=dev)
	M = ptt.MatrixFunction(op, fun="log", deg=DEG, orth=ORTH, dtype=torch.float32)
	(_, res), counts, _ = _counted(torch, lambda: ptt.hutch(M, batch=PROBES, converge="count", count=PROBES, seed=42, full=True, record=True))
	_add(total, counts)
	samples = np.asarray(res.estimator.values, dtype=np.float64)
	with_cov, without = ptt.MeanEstimator(covariance=True, device=dev), ptt.MeanEstimator(device=dev)
	for est in (with_cov, without):
		est.update(torch.tensor(samples, device=dev))
	want = float(np.var(samples, ddof=1))
	row = {"phase": "contract", "part": "mean_estimator", "samples": len(samples), "converged_variance": with_cov.converged_variance,
		"numpy_var_ddof1": want, "rel_err": abs(with_cov.converged_variance - want) / want, "rel_tol": CONTRACT_VAR_RTOL,
		"state_device": str(with_cov.state.mu.device), "without_covariance": without.converged_variance}
	_contract_check(len(samples) == PROBES and row["rel_err"] <= CONTRACT_VAR_RTOL and without.converged_variance is None
		and with_cov.state.mu.is_cuda, row)


def contract(torch, ptt, dev) -> dict:
	"""Phase 27: the JAX package's public contract on the card, (a)-(e) above. Returns the kernels' launches over
	the phase (``contract_launches``)."""
	t0 = time.perf_counter()
	total = {}
	for part in (_contract_sketches, _contract_diag, _contract_special, _contract_from_dense, _contract_mean_estimator):
		part(torch, ptt, dev, total)
		torch.cuda.empty_cache()
	emit({"phase": "contract_done", "seconds": time.perf_counter() - t0, "launches": total})
	for k in ("bsr_spmm", "dia_stencil_t", "lanczos_dia_step", "lanczos_dia_residual"):
		if total.get(k, 0) < 1:
			raise AssertionError(f"the contract phase launched no {k}: {total}")
	return total


# Phase 28: the re-orthogonalised cell (port_bench/traffic/slq_logdet_orth5.json on the 10M path Laplacian): 64
# probes × 10M rows float32, a window of 5 slots, 2 passes; the chain held to its plain version at the full window
# (step 8, 5 slots) and at a partial one (step 1, 2 slots), within the float32 kernel tolerance (max |Δv| over
# max |v|, and Σ|v|² relative).
CGS = dict(orth=5, reorth_passes=2, seed=28, steps=(8, 1), reps=5)


def cgs_window_phase(torch, ptt, dev) -> tuple:
	"""Phase 28: (a) the SLQ logdet at ``orth = 5`` at the cell's shape, counted from zero: within 5% of the exact
	logdet, pass A and the chain once a step (``cgs_window`` 20, no scalar launch), no pass B; (b) the chain against
	``cgs_window_ref`` on the same inputs (q_cur the window's slot j % 5, as the sweep hands it), each step timed beside
	its plain version and its bound, (3s + 6)·nv·n·4 bytes at s valid slots over the HBM rate. Returns the launches of
	(a) and the numbers of (b), the full window's at the top level."""
	from primate_tpu_torch.ops import _common, cgs, dia

	n, nv, ncv, passes = N_LARGE, PROBES, CGS["orth"], CGS["reorth_passes"]
	op = ptt.DIAOperator.from_scipy(build_laplacian(n), dtype=torch.float32, device=dev)
	M = ptt.MatrixFunction(op, fun="log", deg=DEG, orth=ncv, reorth_passes=passes, dtype=torch.float32)
	torch.cuda.synchronize()
	torch.cuda.reset_peak_memory_stats()
	dia.reset_launches()
	t0 = time.perf_counter()
	est = ptt.hutch(M, batch=PROBES, converge="count", count=PROBES, seed=42)
	torch.cuda.synchronize()
	wall = time.perf_counter() - t0
	launches, scalar = dict(_common.LAUNCHES), dict(_common.SCALAR_LAUNCHES)
	exact = exact_logdet(n)
	rel = abs(est - exact) / abs(exact)
	emit({"phase": "cgs_window", "part": "orth5_logdet", "n": n, "probes": nv, "orth": ncv, "reorth_passes": passes,
		"estimate": est, "exact": exact, "rel_err": rel, "wall_s": wall, "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
		"launches": launches, "scalar_launches": scalar})
	if not rel < 0.05:
		raise AssertionError(f"orth 5 logdet rel err {rel} at n={n}")
	want = {"cgs_window": DEG, "lanczos_dia_step": DEG, "lanczos_dia_residual": 0}
	if any(launches[k] != c for k, c in want.items()) or scalar["cgs_window"] != 0:
		raise AssertionError(f"the orth 5 logdet launched {launches} ({scalar} scalar), expected {want} and no scalar cgs_window")
	del op, M
	torch.cuda.empty_cache()

	g = torch.Generator(device=dev)
	g.manual_seed(CGS["seed"])
	Q = torch.randn((ncv, nv, n), generator=g, device=dev)
	Q.div_(torch.linalg.vector_norm(Q, dim=-1, keepdim=True))
	v0 = torch.randn((nv, n), generator=g, device=dev)
	alpha = torch.randn(nv, generator=g, device=dev)
	window = cgs.CgsWindow(Q)
	out = {}
	for j in CGS["steps"]:
		mask, slot = cgs.slot_mask(j, ncv, ncv), j % ncv
		got_v, want_v = v0.clone(), v0.clone()
		before, scalar_before = _common.LAUNCHES["cgs_window"], _common.SCALAR_LAUNCHES["cgs_window"]
		got = window(got_v, mask, passes, alpha, q_slot=slot)
		torch.cuda.synchronize()
		counted = (_common.LAUNCHES["cgs_window"] - before, _common.SCALAR_LAUNCHES["cgs_window"] - scalar_before)
		want = cgs.cgs_window_ref(want_v, Q, mask, passes, alpha, Q[slot])
		err, rel_v = _rel_err(torch, got_v, want_v)
		rel_sq = float(((got - want).abs() / want).max())
		del want_v
		ms, plain_ms = _timed_pair(
			torch, lambda: window(got_v, mask, passes, alpha, q_slot=slot),
			lambda: cgs.cgs_window_ref(got_v, Q, mask, passes, alpha, Q[slot]), CGS["reps"],
		)
		s = bin(mask).count("1")
		bytes_ = (3 * s + 6) * nv * n * 4
		b_ms = bytes_ / HBM_BYTES_PER_S * 1e3
		row = {"step": j, "slots": s, "max_abs_err": err, "rel_err": rel_v, "sq_rel_err": rel_sq, "tol": STENCIL_TOL["float32"],
			"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": "hbm", "share_of_bound": b_ms / ms, "GBps": bytes_ / ms / 1e6,
			"library_ms": None, "chain_launches": counted[0], "chain_scalar_launches": counted[1]}
		emit({"phase": "cgs_window", "part": "chain", "n": n, "probes": nv, "ncv": ncv, "reorth_passes": passes, **row})
		if not (rel_v <= STENCIL_TOL["float32"] and rel_sq <= STENCIL_TOL["float32"] and counted == (1, 0)):
			raise AssertionError(f"the CGS window's chain at step {j}: {row}")
		out.update(row if j == CGS["steps"][0] else {f"partial_{k}": v for k, v in row.items()})
		del got_v
	del Q, v0, window
	torch.cuda.empty_cache()
	return launches["cgs_window"], out


def main() -> None:
	import torch

	if not torch.cuda.is_available():
		sys.exit("chip_smoke: torch.cuda.is_available() is False; this script needs an NVIDIA GPU")
	import primate_tpu_torch as ptt
	from primate_tpu_torch.ops import dia
	from primate_tpu_torch.ops._build import load_library

	dev = torch.device("cuda", 0)
	smi = subprocess.run(
		["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
		capture_output=True, text=True, check=True, timeout=60,
	).stdout.strip()
	print(smi, flush=True)
	t0 = time.perf_counter()
	load_library()
	emit({"phase": "build", "seconds": time.perf_counter() - t0, "torch": torch.__version__, "cuda": torch.version.cuda})

	kernels = check_kernels(torch, dia, dev)
	kernels["lanczos_dia_round"] = {}  # bfloat16 only: its numbers come from phase 24
	kernels["cgs_window"] = {}  # its numbers come from phase 28
	for k, v in check_padded_kernels(torch, dia, dev).items():
		kernels.setdefault(k, {}).update(v)
	flag = flagship(torch, ptt, dia, dev, N_FLAGSHIP, reps=5)
	flagship(torch, ptt, dia, dev, N_LARGE, reps=1)
	trace = plain_trace(torch, ptt, dia, dev)

	bsr_op, bsr_launches = bsr_sketches(torch, ptt, dev, BSR_CELL)
	dia_op, dia_launches, diag_launches = dia_sketches(torch, ptt, dev, FEM_SIDE)
	for k, v in check_sparse_kernels(torch, ptt, bsr_op, dia_op, dev).items():
		kernels.setdefault(k, {}).update(v)
	for k, v in check_backward(torch, ptt, bsr_op, dia_op, dev).items():
		kernels[k].update(v)
	kernels["dia_stencil_t"]["fem_launches"] = diag_launches
	del bsr_op, dia_op

	csr_slq(torch, ptt, dev)
	mesh_op = heat_curve(torch, ptt, dev)
	fav(torch, ptt, dev, mesh_op)
	heat_signature(torch, ptt, dev, mesh_op)
	del mesh_op
	torch.cuda.empty_cache()

	gp = gp_nll(torch, ptt, dev)
	for k in ("dia_stencil_t", "lanczos_dia_step", "lanczos_dia_residual"):
		kernels[k].update({"gp_forward_launches": gp["forward_launches"][k], "gp_backward_launches": gp["backward_launches"][k]})
	batched_cg(torch, ptt, dev)
	torch.cuda.empty_cache()
	for k, v in tight_binding(torch, ptt, dia, dev).items():
		kernels[k].update(v)
	torch.cuda.empty_cache()

	prep = host_prep(torch, ptt, dev)
	torch.cuda.empty_cache()
	eig = eigensolvers(torch, ptt, dev)
	torch.cuda.empty_cache()
	gram, X, fro2 = rectangular(torch, ptt, dev)
	for k in KERNELS:
		kernels[k].update({"prep_launches": prep.get(k, 0), "eig_launches": eig.get(k, 0), "gram_launches": gram.get(k, 0)})
		phases_16_18 = kernels[k]["prep_launches"] + kernels[k]["eig_launches"] + kernels[k]["gram_launches"]
		if k not in SHARDED_ONLY + BF16_ONLY + REORTH_ONLY and phases_16_18 < 1:
			raise AssertionError(f"{k} launched no time in phases 16-18")
	torch.cuda.empty_cache()
	rec = recipes_phase(torch, ptt, dev, X, fro2)
	del X
	for k in KERNELS:
		kernels[k]["recipe_launches"] = rec.get(k, 0)
	torch.cuda.empty_cache()
	for k, v in lanczos_grad(torch, ptt, dev).items():
		kernels[k].update(v)
	torch.cuda.empty_cache()
	for k, v in complex_bsr(torch, ptt, dev).items():
		kernels[k].update(v)
	torch.cuda.empty_cache()
	ex = port_examples(torch, ptt, dev)
	for k in KERNELS:
		kernels[k]["example_launches"] = ex.get(k, 0)
	torch.cuda.empty_cache()
	one = sharded_one_rank(torch, ptt, dev)
	two = sharded_two_ranks(torch)
	for k in KERNELS:
		kernels[k].update({"sharded_launches": one.get(k, 0), "sharded_two_rank_launches": two.get(k, 0)})
	for k in KERNELS:
		if k not in BF16_ONLY and kernels[k]["sharded_launches"] < 1:
			raise AssertionError(f"{k} launched no time through the sharded operators")
	torch.cuda.empty_cache()

	# Phase 24: bfloat16. The four kernels' bf16 instantiations, then the bf16 path's calls, each
	# counted from zero; bf16_launches sums the bf16 launches of those calls.
	for k, v in bf16_kernels(torch, ptt, dev).items():
		kernels[k].update(v)
	bf16, bf16_flag = {}, {}
	for part in (bf16_flagships, bf16_applies, bf16_sharded_one_rank):
		counts = part(torch, ptt, dev)
		if part is bf16_flagships:
			counts, bf16_flag = counts
		_add(bf16, counts)
	_add(bf16, bf16_sharded_two_ranks(torch))
	for k in KERNELS:
		kernels[k]["bf16_launches"] = bf16.get(k, 0)
	kernels["lanczos_dia_advance"]["launches_a_sweep"] = dict(ADVANCE_A_SWEEP)
	for k in BF16_KERNELS:
		if kernels[k]["bf16_launches"] < 1:
			raise AssertionError(f"the bf16 {k} launched no time on the bf16 path")
	torch.cuda.empty_cache()

	# Phase 25: reverse mode on Hermitian operators.
	t0 = time.perf_counter()
	for k, v in hermitian_grad(torch, ptt, dev).items():
		kernels[k].update(v)
	emit({"phase": "hermitian_grad_done", "seconds": time.perf_counter() - t0})
	torch.cuda.empty_cache()

	# Phase 26: the degeneracy-stable quadrature derivative, the coverage matrix and the edge cases.
	for k, v in port_gaps(torch, ptt, dev).items():
		kernels[k].update(v)

	# Phase 27: the JAX package's public contract, held on the card.
	con = contract(torch, ptt, dev)
	for k in KERNELS:
		kernels[k]["contract_launches"] = con.get(k, 0)
	torch.cuda.empty_cache()

	# Phase 28: the CGS window's chain at the re-orthogonalised cell's shape.
	window_launches, numbers = cgs_window_phase(torch, ptt, dev)
	kernels["cgs_window"].update(numbers)

	launches = {
		"dia_stencil_t": trace["launches"]["dia_stencil_t"],
		"lanczos_dia_step": flag["launches"]["lanczos_dia_step"],
		"lanczos_dia_residual": flag["launches"]["lanczos_dia_residual"],
		"lanczos_dia_advance": one.get("lanczos_dia_advance", 0),  # phase 23 (a): the sharded 10M flagship's sweeps
		"lanczos_dia_round": bf16_flag["lanczos_dia_round"],  # phase 24 (b): the 500k full-bf16 flagship
		"bsr_spmm": bsr_launches,
		"dia_stencil": dia_launches,
		"cgs_window": window_launches,  # phase 28 (a): the orth 5 logdet at 10M
	}
	emit({"kernels": [
		{"name": k, "route": "cuda", "source": SOURCE[k], "replaces": REPLACES[k], "launches": launches[k], **kernels[k]}
		for k in KERNELS
	]})
	emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}})


if __name__ == "__main__":
	if sys.argv[1:2] == ["--sharded-rank"]:
		sharded_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], dtype=(sys.argv[5:6] or ["float32"])[0])
	else:
		main()
