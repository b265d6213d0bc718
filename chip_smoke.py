"""Run the PyTorch port's main path on one NVIDIA GPU and check its CUDA kernels.

    python3 chip_smoke.py

Builds the kernels of ``primate_tpu_torch/csrc`` with nvcc (sm_90a), then:

1. prints the card's name and power limit, and the build time;
2. holds each kernel against its plain PyTorch version on the card, float32 and
   float64, at the flagship shape and at an awkward one;
3. runs the flagship SLQ logdet (``bench.py``'s configuration) at n = 500,000 in
   float32: the estimate must be within 5% of the exact logdet, and the fused
   Lanczos-step kernel must have launched deg × batches times;
4. runs the same at n = 10,000,000 and reports wall time and peak memory;
5. runs the plain trace ``hutch(DIAOperator(L))`` at n = 500,000: within 5σ of
   tr(L) = 3n, through the stencil kernel;
6. holds the BSR SpMM and the node-major DIA stencil against their plain
   versions, float32 and float64, at the cell operators of phases 7 and 8
   (k = 64 and 240) and at awkward shapes, and times kernel, plain version and
   (for the DIA stencil) the transpose route through the probe-major kernel;
   it runs last, on the operators that phases 7 and 8 built;
7. runs BASELINE config 3's sketch estimators (``benchmarks/configs.py:73-105``)
   on ``block_random_spd(n=1,048,576)`` as a BSR operator with 8×8 tiles, at
   the scale of the SuiteSparse matrix audikw_1: each trace within 1e-3 of
   tr(S), and the BSR kernel launched once per operator application;
8. runs Hutch++, XDiag, Diag++ and the Girard-Hutchinson diagonal on the 3-D FEM
   Laplacian ``fem_laplacian_3d(side=100)`` (n = 1,000,000, offsets ±1, ±100,
   ±10,000) as a DIA operator: trace within 1e-3, diagonals within 0.1 (relative L2).

Each phase raises on failure. Measured values go out as JSON lines; the last
line is ``{"ok": true, "device": {...}}``. Without a CUDA device it exits
non-zero before printing anything.
"""

import json
import statistics
import subprocess
import sys
import time

import numpy as np

DEG, PROBES, ORTH = 20, 64, 0
N_FLAGSHIP, N_LARGE = 500_000, 10_000_000
SOURCE = {
	"dia_stencil_t": "primate_tpu_torch/csrc/dia_stencil.cu",
	"lanczos_dia_step": "primate_tpu_torch/csrc/dia_stencil.cu",
	"bsr_spmm": "primate_tpu_torch/csrc/bsr_spmm.cu",
	"dia_stencil": "primate_tpu_torch/csrc/dia_stencil.cu",
}
REPLACES = {
	"dia_stencil_t": "primate_tpu/ops/dia_pallas.py:152",  # dia_matmat_t_pallas's pallas_call
	"lanczos_dia_step": "primate_tpu/ops/dia_pallas.py:273",  # dia_matmat_t_phys's pallas_call
	"bsr_spmm": "primate_tpu/ops/spmm_pallas.py:96",  # bsr_matmat_pallas's pallas_call
	"dia_stencil": "primate_tpu/ops/dia_pallas.py:93",  # dia_matmat_pallas's pallas_call
}
STENCIL_TOL = {"float32": 1e-5, "float64": 1e-12}  # max-abs error over max|out|
# Phase 7: BASELINE config 3 at audikw_1's scale (943,695 rows, 77.7M nonzeros).
BSR_CELL = dict(n=1_048_576, bs=8, density=3.5e-5, seed=7)
FEM_SIDE = 100  # phase 8: n = side**3
TRACE_TOL, DIAG_TOL = 1e-3, 0.1
# Node-major operator applications per call (the JAX programs' matmat count).
BSR_APPLIES = {"hutchpp": 3, "xtrace": 8, "xnystrace": 1, "xdiag": 2}
ALPHA_TOL = {"float32": 1e-4, "float64": 1e-10}  # relative: the summation orders differ


def emit(obj) -> None:
	print(json.dumps(obj), flush=True)


def build_laplacian(n: int):
	"""The path-graph Laplacian tridiag(-1, 3, -1) of bench.py:73-76."""
	import scipy.sparse as sps

	main = 3.0 * np.ones(n, np.float32)
	off = -1.0 * np.ones(n - 1, np.float32)
	return sps.diags([off, main, off], [-1, 0, 1]).tocsr().astype(np.float32)


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


def check_kernels(torch, dia, dev) -> dict:
	"""Phase 2: each kernel against its plain version on the same inputs on the card."""
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
			x = torch.randn((nv, n), generator=gen, device=dev, dtype=dtype)
			q_cur = torch.randn((nv, n), generator=gen, device=dev, dtype=dtype)
			q_cur /= torch.linalg.vector_norm(q_cur, dim=1, keepdim=True)
			q_prev = torch.randn((nv, n), generator=gen, device=dev, dtype=dtype)
			q_prev /= torch.linalg.vector_norm(q_prev, dim=1, keepdim=True)
			beta = torch.rand(nv, generator=gen, device=dev, dtype=dtype) + 0.5

			got, want = dia.dia_stencil_t(bands, offs, x), dia.dia_stencil_t_ref(bands, offs_host, x)
			v, alpha = dia.lanczos_dia_step(bands, offs, q_cur, q_prev, beta)
			v_ref, alpha_ref = dia.lanczos_dia_step_ref(bands, offs_host, q_cur, q_prev, beta)
			torch.cuda.synchronize()
			err_s = float((got - want).abs().max())
			err_v = float((v - v_ref).abs().max())
			err_a = float((alpha - alpha_ref).abs().max())
			rel_s = err_s / float(want.abs().max())
			rel_v = err_v / float(v_ref.abs().max())
			rel_a = float(((alpha - alpha_ref).abs() / alpha_ref.abs()).max())
			row = {"phase": "kernel_check", "shape": label, "nv": nv, "n": n, "offsets": list(offsets), "dtype": name,
				"stencil_max_abs_err": err_s, "stencil_rel_err": rel_s, "step_v_max_abs_err": err_v,
				"step_v_rel_err": rel_v, "alpha_max_abs_err": err_a, "alpha_rel_err": rel_a}
			if label == "flagship" and dtype == torch.float32:
				ms = {}
				for k, kern, plain in (
					("dia_stencil_t", lambda: dia.dia_stencil_t(bands, offs, x), lambda: dia.dia_stencil_t_ref(bands, offs_host, x)),
					("lanczos_dia_step", lambda: dia.lanczos_dia_step(bands, offs, q_cur, q_prev, beta),
						lambda: dia.lanczos_dia_step_ref(bands, offs_host, q_cur, q_prev, beta)),
				):
					p1, k1, k2, p2 = time_ms(torch, plain), time_ms(torch, kern), time_ms(torch, kern), time_ms(torch, plain)
					ms[k] = ((k1 + k2) / 2, (p1 + p2) / 2)
				item = 4
				bytes_a = (2 * nv * n + len(offsets) * n) * item
				bytes_b = (3 * nv * n + len(offsets) * n) * item
				row.update({
					"stencil_ms": ms["dia_stencil_t"][0], "stencil_plain_ms": ms["dia_stencil_t"][1],
					"stencil_GBps": bytes_a / ms["dia_stencil_t"][0] / 1e6,
					"step_ms": ms["lanczos_dia_step"][0], "step_plain_ms": ms["lanczos_dia_step"][1],
					"step_GBps": bytes_b / ms["lanczos_dia_step"][0] / 1e6,
				})
				out = {"dia_stencil_t": (err_s, *ms["dia_stencil_t"]), "lanczos_dia_step": (max(err_v, err_a), *ms["lanczos_dia_step"])}
			emit(row)
			if not (rel_s <= STENCIL_TOL[name] and rel_v <= STENCIL_TOL[name] and rel_a <= ALPHA_TOL[name]):
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
	if launches["lanczos_dia_step"] != DEG * batches:
		raise AssertionError(f"fused step launched {launches['lanczos_dia_step']} times, expected {DEG * batches}")
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


def _timed_pair(torch, kern, plain, reps: int) -> tuple:
	"""Kernel and plain version by CUDA events, in the order plain, kernel, kernel, plain."""
	p1, k1, k2, p2 = (time_ms(torch, f, reps) for f in (plain, kern, kern, plain))
	return (k1 + k2) / 2, (p1 + p2) / 2


def check_sparse_kernels(torch, ptt, bsr_op, dia_op, dev, cell_ks=(64, 240), reps: int = 10) -> dict:
	"""Phase 6: the BSR SpMM and the node-major DIA stencil against their plain
	versions at the cell operators and at awkward shapes, float32 and float64."""
	import scipy.sparse as sps
	from primate_tpu_torch.ops import bsr, dia

	gen = torch.Generator(device=dev)
	gen.manual_seed(1)
	out = {}

	def run(label, name, kern, plain, dtype, k, timed=False, bytes_=0, route=None):
		tname = str(dtype).removeprefix("torch.")
		got, want = kern(), plain()
		torch.cuda.synchronize()
		err, rel = _rel_err(torch, got, want)
		row = {"phase": "sparse_kernel_check", "kernel": name, "shape": label, "k": k, "dtype": tname,
			"max_abs_err": err, "rel_err": rel, "tol": STENCIL_TOL[tname]}
		if timed:
			ms, plain_ms = _timed_pair(torch, kern, plain, reps)
			row.update({"ms": ms, "plain_ms": plain_ms, "GBps": bytes_ / ms / 1e6})
			if route is not None:
				row["transpose_route_ms"] = time_ms(torch, route, reps)
			if k == cell_ks[0]:
				out[name] = (err, ms, plain_ms)
		emit(row)
		if not rel <= STENCIL_TOL[tname]:
			raise AssertionError(f"{name} disagrees with its plain version: {row}")

	for dtype in (torch.float32, torch.float64):
		B = ptt.BSROperator(bsr_op.blocks.to(dtype), bsr_op.indices, bsr_op.indptr, bsr_op.shape)
		D = ptt.DIAOperator(dia_op.bands.to(dtype), dia_op.offsets, dia_op.shape)
		offs_host = D.offsets_t.cpu()
		for k in cell_ks:
			timed = dtype == torch.float32
			V = torch.randn((B.shape[0], k), generator=gen, device=dev, dtype=dtype)
			args = (B.blocks, B.indptr, B.indices, V, B.shape[0])
			run("bsr_cell", "bsr_spmm", lambda: bsr.bsr_spmm(*args), lambda: bsr.bsr_spmm_ref(*args), dtype, k,
				timed, _bytes_bsr(B, k, V.element_size()))
			del V
			V = torch.randn((D.shape[0], k), generator=gen, device=dev, dtype=dtype)
			run("fem_cell", "dia_stencil", lambda: dia.dia_stencil(D.bands, D.offsets_t, V),
				lambda: dia.dia_stencil_ref(D.bands, offs_host, V), dtype, k, timed,
				(2 * D.shape[0] * k + D.nnz) * V.element_size(),
				route=lambda: dia.dia_stencil_t(D.bands, D.offsets_t, V.T.contiguous()).T)
			del V
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
			for k in (1, 130, 720):
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


def bsr_sketches(torch, ptt, dev, cell: dict) -> tuple:
	"""Phase 7: BASELINE config 3's calls on the BSR cell, float32."""
	from benchmarks.matrices import block_random_spd

	t0 = time.perf_counter()
	S = block_random_spd(**cell)
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
	return op, launches


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
	dia_op, dia_launches = dia_sketches(torch, ptt, dev, FEM_SIDE)
	kernels.update(check_sparse_kernels(torch, ptt, bsr_op, dia_op, dev))

	launches = {
		"dia_stencil_t": trace["launches"]["dia_stencil_t"],
		"lanczos_dia_step": flag["launches"]["lanczos_dia_step"],
		"bsr_spmm": bsr_launches,
		"dia_stencil": dia_launches,
	}
	emit({"kernels": [
		{"name": k, "route": "cuda", "source": SOURCE[k], "replaces": REPLACES[k], "launches": launches[k],
			"max_abs_err": kernels[k][0], "ms": kernels[k][1], "plain_ms": kernels[k][2]}
		for k in ("dia_stencil_t", "lanczos_dia_step", "bsr_spmm", "dia_stencil")
	]})
	emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}})


if __name__ == "__main__":
	main()
