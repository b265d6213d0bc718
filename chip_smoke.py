"""Run the PyTorch port's main path on one NVIDIA GPU and check its CUDA kernels.

    python3 chip_smoke.py

Builds the kernels of ``primate_tpu_torch/csrc`` with nvcc (sm_90a), then:

1. prints the card's name and power limit, and the build time;
2. holds each DIA kernel and the two passes of the Lanczos step against their
   plain PyTorch versions on the card, float32 and float64, at the flagship shape
   and at an awkward one, and times each at the flagship shape beside its bound
   and, where one PyTorch call computes the same function, that call (``library_ms``);
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
   and at awkward ones, timed beside bound, plain version and complex cuSPARSE; then, each
   counted and timed, ``kpm_trace`` of x² and x⁴ against the closed forms 4n and
   (28 + 8 cos 2πα)·n (10 σ of its own probes), the KPM density (mass 1, second moment 4),
   Lanczos against Chebyshev quadrature probe for probe (1e-4), the β sweep of
   ``tr e^{−βH}`` (48 probe-major stencils a batch, no step kernel; within 2% of the KPM
   density's), ``diag`` of H² (mean 4 within 1e-3, L2 error within 10% of its closed form),
   the LDOS window, the SLQ density, Hutch++ of H·H (within 1e-2 of 4n; two node-major
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
   4σ of each other, the Gram density's mass within 1e-2, and ``bsr_spmm`` in both directions.

Phase 6 ends with the backward check: each kernel's ``torch.autograd.Function``
(``primate_tpu_torch/ops/autograd.py``) against autograd through its plain version, float32
and float64, at phase 6's cell shapes, on non-symmetric bands and on a misaligned block,
its backward timed beside the plain version's.

Each phase raises on failure. Measured values go out as JSON lines; the line
before the last lists every kernel with its launches on its path, its error
against its plain version, its time, its plain version's time, its bound
(``bound_ms``: the larger of its bytes over the HBM rate and its flops over the
float32 rate) and its library call's time (``library_ms``, null where no single
call computes it); for ``dia_stencil_t`` the same numbers at the FEM ``diag``
shape follow under ``fem_`` keys, with its launches in that call
(``fem_launches``); the three kernels with a backward carry its error
(``grad_max_abs_err``, over float32 and float64, relative to the largest entry) and
times (``backward_ms``, ``backward_plain_ms``), and the three kernels of phase 13 their
launches in its forward and backward passes (``gp_forward_launches``,
``gp_backward_launches``), and the two stencils their complex64 numbers at phase 15's cell
shapes under ``c64_`` keys, with ``c64_launches`` the complex launches of its calls 2-8;
every kernel also carries its launches in phases 16, 17 and 18 (``prep_launches``,
``eig_launches``, ``gram_launches``); the last line is ``{"ok": true, "device": {...}}``.
Without a CUDA device it exits non-zero before printing anything.
"""

import functools
import json
import statistics
import subprocess
import sys
import time

import numpy as np

DEG, PROBES, ORTH = 20, 64, 0
N_FLAGSHIP, N_LARGE = 500_000, 10_000_000
KERNELS = ("dia_stencil_t", "lanczos_dia_step", "lanczos_dia_residual", "bsr_spmm", "dia_stencil")
SOURCE = {
	"dia_stencil_t": "primate_tpu_torch/csrc/dia_stencil.cu",
	"lanczos_dia_step": "primate_tpu_torch/csrc/dia_stencil.cu",
	"lanczos_dia_residual": "primate_tpu_torch/csrc/dia_stencil.cu",
	"bsr_spmm": "primate_tpu_torch/csrc/bsr_spmm.cu",
	"dia_stencil": "primate_tpu_torch/csrc/dia_stencil.cu",
}
REPLACES = {
	"dia_stencil_t": "primate_tpu/ops/dia_pallas.py:152",  # dia_matmat_t_pallas's pallas_call
	# The two passes of the Lanczos step together replace dia_matmat_t_phys's
	# pallas_call and the XLA-fused rest of the step around it.
	"lanczos_dia_step": "primate_tpu/ops/dia_pallas.py:273",
	"lanczos_dia_residual": "primate_tpu/ops/dia_pallas.py:273",
	"bsr_spmm": "primate_tpu/ops/spmm_pallas.py:96",  # bsr_matmat_pallas's pallas_call
	"dia_stencil": "primate_tpu/ops/dia_pallas.py:93",  # dia_matmat_pallas's pallas_call
}
# NVIDIA H100 SXM data sheet: HBM3 at 3.35 TB/s, 67 TFLOP/s float32 outside the
# tensor cores (the kernels run FP32 FMAs on the CUDA cores).
HBM_BYTES_PER_S, FP32_FLOP_PER_S = 3.35e12, 67e12
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


def emit(obj) -> None:
	print(json.dumps(obj), flush=True)


def build_laplacian(n: int):
	"""The path-graph Laplacian tridiag(-1, 3, -1) of bench.py:73-76."""
	import scipy.sparse as sps

	main = 3.0 * np.ones(n, np.float32)
	off = -1.0 * np.ones(n - 1, np.float32)
	return sps.diags([off, main, off], [-1, 0, 1]).tocsr().astype(np.float32)


def hofstadter_csr(nx: int, ny: int, alpha: float):
	"""The periodic square-lattice Hofstadter Hamiltonian of ``examples/tight_binding.py``
	(``hofstadter_hamiltonian``), vectorised: site ``i = x·ny + y``; x-hops −1, y-hops
	``H[i, j] = −e^{2πiαx}`` and its conjugate; scipy CSR, complex128."""
	import scipy.sparse as sps

	n = nx * ny
	x, y = np.repeat(np.arange(nx), ny), np.tile(np.arange(ny), nx)
	i, jx, jy = x * ny + y, (x + 1) % nx * ny + y, x * ny + (y + 1) % ny
	t = -np.exp(2j * np.pi * alpha * x)
	rows, cols = np.concatenate([i, jx, i, jy]), np.concatenate([jx, i, jy, i])
	vals = np.concatenate([-np.ones(2 * n), t, np.conj(t)])
	return sps.csr_matrix((vals, (rows, cols)), shape=(n, n), dtype=np.complex128)


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


def bound(bytes_: float, flops: float) -> tuple:
	"""The least time the card could take (ms) and what sets it."""
	t_bytes, t_flops = bytes_ / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOP_PER_S * 1e3
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
	on the same inputs on the card; times at the flagship shape in float32."""
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
			emit(row)
			if not (rel_s <= STENCIL_TOL[name] and rel_v <= STENCIL_TOL[name] and rel_a <= ALPHA_TOL[name]
				and rel_w <= STENCIL_TOL[name] and rel_ab <= ALPHA_TOL[name]):
				raise AssertionError(f"kernel disagrees with its plain version: {row}")
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


def _timed_pair(torch, kern, plain, reps: int) -> tuple:
	"""Kernel and plain version by CUDA events, in the order plain, kernel, kernel, plain."""
	p1, k1, k2, p2 = (time_ms(torch, f, reps) for f in (plain, kern, kern, plain))
	return (k1 + k2) / 2, (p1 + p2) / 2


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
				gathered = _gathered_bytes_bsr(B, k, item)
				emit({"phase": "bsr_traffic", "k": k, "least_bytes": _bytes_bsr(B, k, item), "gathered_bytes": gathered,
					"gathered_GBps": gathered / row["ms"] / 1e6, "least_share_of_bound": row["bound_ms"] / row["ms"]})
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
	complex64 cell shapes timed beside their bound, their plain version and the complex cuSPARSE
	product. Each launch that must take the complex64 scalar path is counted in ``SCALAR_LAUNCHES``."""
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
			out[name] = {"c64_max_abs_err": err, "c64_ms": ms, "c64_plain_ms": plain_ms, "c64_bound_ms": b_ms,
				"c64_bound_by": b_by, "c64_library_ms": lib_ms}
		emit(row)
		if not rel <= CPLX_TOL[tname]:
			raise AssertionError(f"complex {name} disagrees with its plain version: {row}")
		if took_scalar != int(scalar):
			raise AssertionError(f"complex {name} took its scalar path {took_scalar} times, expected {int(scalar)}: {row}")

	for dtype in (torch.complex64, torch.complex128):
		c64 = dtype == torch.complex64
		item = 8 if c64 else 16
		bands = op.bands.to(dtype)
		A_csr = csr_of_dia(torch, bands, op.offsets, n) if c64 else None
		# A complex multiply-add is 8 real operations; complex64 runs them in float32.
		X = crandn((TB_NV, n), dtype)
		check("cell_probe_major", "dia_stencil_t", lambda: dia.dia_stencil_t(bands, offs, X),
			lambda: dia.dia_stencil_t_ref(bands, offs_host, X), dtype, False,
			timed=((2 * TB_NV * n + n_d * n) * item, 8 * n_d * TB_NV * n) if c64 else None,
			library=lambda: (A_csr @ X.T).T)
		del X
		V = crandn((n, 64), dtype)
		check("cell_node_major", "dia_stencil", lambda: dia.dia_stencil(bands, offs, V),
			lambda: dia.dia_stencil_ref(bands, offs_host, V), dtype, False,
			timed=((2 * 64 * n + n_d * n) * item, 8 * n_d * 64 * n) if c64 else None, library=lambda: A_csr @ V)
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
	launched("lanczos_quad", counts_l, {"dia_stencil_t": 40, **no_steps})
	launched("chebyshev_quad", counts_c, {"dia_stencil_t": 63, **no_steps})
	q_l, q_c = q_l.double().cpu().numpy(), q_c.double().cpu().numpy()
	rel = float(np.max(np.abs(q_l - q_c) / np.abs(q_c)))
	done("lanczos_quad", True)
	done("chebyshev_quad", rel <= 1e-4, per_probe_rel_diff_max=rel, limit=1e-4)
	betas = np.array(TB_BETAS)
	sweep = ptt.MatrixFunction(op, ptt.stacked("exp", -betas), deg=48, orth=0)
	Z, counts = run("beta_sweep", lambda: ptt.hutch(sweep, pdf="phase", batch=16, converge="count", count=64, seed=155),
		betas=betas.tolist(), deg=48, batch=16, count=64)
	launched("beta_sweep", counts, {"dia_stencil_t": 48 * 4, **no_steps})
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
	launched("spectral_density", counts, {"dia_stencil_t": 64, **no_steps})
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
	complex64 DIA operator: the complex stencils held to their plain versions (call 1), then the
	example's calls through the port (calls 2-8, ``_tb_calls``)."""
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
	calls = _tb_calls(torch, ptt, dev, op, H)
	for k in ("dia_stencil_t", "dia_stencil"):  # the complex launches of calls 2-8, each counted from 0
		kernels[k]["c64_launches"] = sum(r["launches"][k] for r in calls.values())
	return kernels


# --- Phases 16-18: the host loader and auto_operator, the eigensolvers, rectangular spectra ---


def _walls(torch, fn, long_s: float = 5.0) -> tuple:
	"""The counted call (launch and copy counts from 0) and its walls: the median of 3 synced
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
	for _ in range(3):
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
	"""The Dirichlet 5-point Laplacian of ``examples/spectrum_slicing.py`` (rebuilt here: that example
	imports jax), and its eigenvalues ``4 sin²(jπ/2(nx+1)) + 4 sin²(kπ/2(ny+1))``, sorted."""
	import scipy.sparse as sps

	ex, ey = np.ones(nx), np.ones(ny)
	Tx = sps.diags([-ex[:-1], 2 * ex, -ex[:-1]], [-1, 0, 1])
	Ty = sps.diags([-ey[:-1], 2 * ey, -ey[:-1]], [-1, 0, 1])
	A = (sps.kron(sps.identity(ny), Tx) + sps.kron(Ty, sps.identity(nx))).tocsr().astype(np.float32)
	jx, jy = np.arange(1, nx + 1), np.arange(1, ny + 1)
	lam = (4 * np.sin(jx * np.pi / (2 * (nx + 1))) ** 2)[:, None] + (4 * np.sin(jy * np.pi / (2 * (ny + 1))) ** 2)[None, :]
	return A, np.sort(lam.ravel())


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


def rectangular(torch, ptt, dev) -> dict:
	"""Phase 18: ``examples/rectangular_spectra.py`` at scale: X = L Rᵀ + σ G (G the BSR noise
	operator), its top singular values by ``svds``, ``rsvd`` and ``lanczos_bidiag``, ‖X‖²_F and the
	nuclear norm by Gram quadrature, and the Gram density; the adjoint applies (G's and a DIA
	operator's) against their plain versions, and the Gram path over that DIA operator. Returns
	the path's launches."""
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
	return total


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
	gram = rectangular(torch, ptt, dev)
	for k in KERNELS:
		kernels[k].update({"prep_launches": prep.get(k, 0), "eig_launches": eig.get(k, 0), "gram_launches": gram.get(k, 0)})
		if kernels[k]["prep_launches"] + kernels[k]["eig_launches"] + kernels[k]["gram_launches"] < 1:
			raise AssertionError(f"{k} launched no time in phases 16-18")

	launches = {
		"dia_stencil_t": trace["launches"]["dia_stencil_t"],
		"lanczos_dia_step": flag["launches"]["lanczos_dia_step"],
		"lanczos_dia_residual": flag["launches"]["lanczos_dia_residual"],
		"bsr_spmm": bsr_launches,
		"dia_stencil": dia_launches,
	}
	emit({"kernels": [
		{"name": k, "route": "cuda", "source": SOURCE[k], "replaces": REPLACES[k], "launches": launches[k], **kernels[k]}
		for k in KERNELS
	]})
	emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}})


if __name__ == "__main__":
	main()
