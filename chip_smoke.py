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
   tr(L) = 3n, through the stencil kernel.

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
SOURCE = "primate_tpu_torch/csrc/dia_stencil.cu"
REPLACES = {
	"dia_stencil_t": "primate_tpu/ops/dia_pallas.py:152",  # dia_matmat_t_pallas's pallas_call
	"lanczos_dia_step": "primate_tpu/ops/dia_pallas.py:273",  # dia_matmat_t_phys's pallas_call
}
STENCIL_TOL = {"float32": 1e-5, "float64": 1e-12}  # max-abs error over max|out|
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

	launches = {"dia_stencil_t": trace["launches"]["dia_stencil_t"], "lanczos_dia_step": flag["launches"]["lanczos_dia_step"]}
	emit({"kernels": [
		{"name": k, "route": "cuda", "source": SOURCE, "replaces": REPLACES[k], "launches": launches[k],
			"max_abs_err": kernels[k][0], "ms": kernels[k][1], "plain_ms": kernels[k][2]}
		for k in ("dia_stencil_t", "lanczos_dia_step")
	]})
	emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}})


if __name__ == "__main__":
	main()
