"""Where the device time of the port's main calls goes, on one NVIDIA GPU.

    python3 profile_port.py [--out profile_port.json]

Traces with ``torch.profiler`` one call of each after a warm-up: the flagship SLQ
logdet of ``chip_smoke.py`` at n = 500,000 and 10,000,000, BASELINE config 3's
sketch estimators on its 1M-row BSR cell, the calls of its phase 8 on the FEM
DIA cell (Hutch++, XDiag, Diag++, ``diag``), and the calls of its phases 9-12: the
CSR graph logdet (``powerlaw_laplacian(1M)``), the heat-kernel curve, exp(−L)V in
one and two passes, and the heat-kernel signature on the 1000×1000 mesh; then its phase 13,
the GP log-likelihood at n = 10M (the forward pass alone, and forward and backward);
its phase 14, Jacobi-preconditioned CG on the power-law graph with 64 right-hand
sides; and its phase 15 on the 4M-site Hofstadter model (complex64 DIA): the KPM
density of states, the β sweep of ``tr e^{−βH}`` and the local density of states; and the
calls of its phases 17 and 18: LOBPCG and thick-restart ``eigsh`` and ``block_slq_trace`` on
the mesh, ``filtered_eigsh`` on the grid Laplacian, ``svds`` and the nuclear norm (the
``AAᵀ`` Gram side) of the rectangular data operator.
Prints one JSON line per call: the
traced host wall (ms), the summed device time of its kernels (ms), the device's
busy share of the wall, and the kernels that take the most device time (ms and
count); writes them all to ``--out``. Needs a CUDA device; without one it exits
non-zero.
"""

import argparse
import json
import subprocess
import sys
import time

import numpy as np


def _device_ms(evt) -> float:
	return (getattr(evt, "self_device_time_total", None) or getattr(evt, "self_cuda_time_total", 0.0)) / 1e3


def trace(torch, fn, top: int = 8) -> dict:
	"""One warm-up call, then one traced call ending in a device sync."""
	from torch.autograd import DeviceType
	from torch.profiler import ProfilerActivity, profile

	fn()
	torch.cuda.synchronize()
	with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
		t0 = time.perf_counter()
		fn()
		torch.cuda.synchronize()
		wall_ms = (time.perf_counter() - t0) * 1e3
	kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and _device_ms(e) > 0]
	kernels.sort(key=_device_ms, reverse=True)
	device_ms = sum(_device_ms(e) for e in kernels)
	return {"wall_ms": wall_ms, "device_ms": device_ms, "busy_share": device_ms / wall_ms,
		"top": [{"kernel": e.key[:90], "ms": _device_ms(e), "count": e.count} for e in kernels[:top]]}


def main() -> None:
	ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
	ap.add_argument("--out", default="profile_port.json")
	args = ap.parse_args()
	import torch

	if not torch.cuda.is_available():
		sys.exit("profile_port: torch.cuda.is_available() is False; this script needs an NVIDIA GPU")
	import chip_smoke as cs
	import primate_tpu_torch as ptt
	from benchmarks.matrices import block_random_spd

	dev = torch.device("cuda", 0)
	rows = []
	for n in (cs.N_FLAGSHIP, cs.N_LARGE):
		op = ptt.DIAOperator.from_scipy(cs.build_laplacian(n), dtype=torch.float32, device=dev)
		M = ptt.MatrixFunction(op, fun="log", deg=cs.DEG, orth=cs.ORTH, reorth_passes=1, dtype=torch.float32)
		row = {"call": f"flagship_{n}", **trace(torch, lambda: ptt.hutch(M, batch=cs.PROBES, converge="count", count=cs.PROBES, seed=42))}
		print(json.dumps(row), flush=True)
		rows.append(row)
		del op, M
	S = block_random_spd(**cs.BSR_CELL)
	op = ptt.BSROperator.from_scipy(S, blocksize=(cs.BSR_CELL["bs"], cs.BSR_CELL["bs"]), dtype=torch.float32, device=dev)
	calls = {
		"bsr_hutchpp": lambda: ptt.hutchpp(op, m=240, seed=7),
		"bsr_xtrace": lambda: ptt.xtrace(op, batch=64, converge="count", count=256, seed=7),
		"bsr_xnystrace": lambda: ptt.xnystrace(op, m=720, seed=7),
		"bsr_xdiag": lambda: ptt.xdiag(op, m=256, seed=7),
	}
	for name, fn in calls.items():
		row = {"call": name, **trace(torch, fn)}
		print(json.dumps(row), flush=True)
		rows.append(row)
	del op, S
	from benchmarks.matrices import fem_laplacian_3d

	op = ptt.DIAOperator.from_scipy(fem_laplacian_3d(cs.FEM_SIDE), dtype=torch.float32, device=dev)
	calls = {  # chip_smoke.py phase 8
		"fem_hutchpp": lambda: ptt.hutchpp(op, m=240, seed=8),
		"fem_xdiag": lambda: ptt.xdiag(op, m=256, pdf="rademacher", seed=8),
		"fem_diagpp": lambda: ptt.diagpp(op, m=240, seed=8),
		"fem_diag": lambda: ptt.diag(op, batch=64, converge="count", count=256, seed=8),
	}
	for name, fn in calls.items():
		row = {"call": name, **trace(torch, fn)}
		print(json.dumps(row), flush=True)
		rows.append(row)
	del op
	from benchmarks.matrices import powerlaw_laplacian

	_, run = cs._csr_slq(torch, ptt, powerlaw_laplacian(n=cs.PL_N, m=4, seed=0), dev, seed=9)
	mesh = ptt.DIAOperator.from_scipy(cs.mesh_laplacian(cs.MESH_SIDE), dtype=torch.float32, device=dev)
	fam = ptt.stacked("exp", -cs.TAUS)
	gen = torch.Generator(device=dev)
	gen.manual_seed(11)
	V = torch.randn((mesh.shape[0], 8), generator=gen, device=dev, dtype=torch.float32)
	calls = {
		"csr_slq_1m": run,
		"heat_curve": lambda: ptt.hutch(ptt.MatrixFunction(mesh, fam, deg=20, orth=0), batch=32, converge="count", count=32, seed=10),
		"fav_one_pass": lambda: ptt.MatrixFunction(mesh, "exp", t=-1.0, deg=20, orth=0).matmat(V),
		"fav_two_pass": lambda: ptt.MatrixFunction(mesh, "exp", t=-1.0, deg=20, orth=0, two_pass=True).matmat(V),
		"heat_signature": lambda: ptt.diag(ptt.MatrixFunction(mesh, fam, deg=20, orth=0), batch=64, converge="count", count=8, seed=12),
	}
	for name, fn in calls.items():
		row = {"call": name, **trace(torch, fn)}
		print(json.dumps(row), flush=True)
		rows.append(row)
	del mesh, V, run
	n = cs.N_LARGE
	y = torch.randn(n, generator=gen, device=dev, dtype=torch.float32)

	def gp(backward: bool):
		theta = torch.zeros(2, dtype=torch.float32, device=dev, requires_grad=True)
		K = ptt.DIAOperator(cs._dirichlet_bands(torch, theta, n, dev), (-1, 0, 1), (n, n))
		nll = 0.5 * (ptt.autodiff.logdet(K, **cs.GP) + y @ ptt.solve(K, y, rtol=cs.GP["solver_rtol"]))
		if backward:
			nll.backward()

	G = ptt.CSROperator.from_scipy(powerlaw_laplacian(n=cs.PL_N, m=4, seed=0), dtype=torch.float32, device=dev)
	B = ptt.sample_isotropic(gen, (cs.PL_N, cs.CG_RHS), pdf="rademacher", dtype=torch.float32)
	calls = {
		"gp_nll_forward": lambda: gp(False),
		"gp_nll_forward_backward": lambda: gp(True),
		"cg_jacobi_1m": lambda: ptt.cg(G, B, rtol=cs.CG_RTOL, precond="jacobi"),
	}
	for name, fn in calls.items():
		row = {"call": name, **trace(torch, fn)}
		print(json.dumps(row), flush=True)
		rows.append(row)
	del G, B
	H = ptt.DIAOperator.from_scipy(cs.hofstadter_csr(**cs.TB), dtype=torch.complex64, device=dev)
	sweep = ptt.MatrixFunction(H, ptt.stacked("exp", -np.array(cs.TB_BETAS)), deg=48, orth=0)
	window = ptt.ChebyshevFunction(H, lambda x: torch.exp(-(x**2) / 0.02) / (0.1 * np.sqrt(2 * np.pi)), deg=256, seed=157)
	calls = {  # chip_smoke.py phase 15
		"tb_kpm_density": lambda: ptt.kpm_density(H, grid=512, m=512, nv=cs.TB_NV, pdf="phase", interval="gershgorin", seed=153),
		"tb_beta_sweep": lambda: ptt.hutch(sweep, pdf="phase", batch=16, converge="count", count=64, seed=155),
		"tb_ldos": lambda: ptt.diag(window, pdf="phase", batch=16, converge="count", count=4, seed=3),
	}
	for name, fn in calls.items():
		row = {"call": name, **trace(torch, fn)}
		print(json.dumps(row), flush=True)
		rows.append(row)
	del H, sweep, window
	mesh = ptt.DIAOperator.from_scipy(cs.mesh_laplacian(cs.MESH_SIDE), dtype=torch.float32, device=dev)
	grid, lam = cs.grid_laplacian(*cs.FE_GRID)
	gop = ptt.DIAOperator.from_scipy(grid, dtype=torch.float32, device=dev)
	lo, hi = ptt.operators.gershgorin_interval(gop)
	b = float(0.5 * (lam[cs.FE_COUNT - 1] + lam[cs.FE_COUNT]))
	deg = int(np.ceil(2.0 * (hi - lo) / b))
	R = cs.RECT
	G = cs.rect_noise(torch, ptt, dev, R["m"], R["n"], R["bs"], R["tiles_per_block_row"], R["seed"])
	rng = np.random.default_rng(R["seed"] + 1)
	L = torch.tensor(rng.standard_normal((R["m"], R["r"])) / np.sqrt(R["m"]), dtype=torch.float32, device=dev)
	Rt = torch.tensor((rng.standard_normal((R["n"], R["r"])) * np.geomspace(20.0, 2.0, R["r"])).T.copy(), dtype=torch.float32, device=dev)
	X = ptt.ComposedOperator(L, Rt) + R["sigma"] * G
	nuc = ptt.MatrixFunction(ptt.GramOperator(X, transpose_first=False), "sqrt")
	calls = {  # chip_smoke.py phases 17 and 18
		"eigsh_lobpcg_la": lambda: ptt.eigsh(mesh, k=cs.EIG_K, which="LA", maxiter=cs.EIG_MAXITER, tol=cs.EIG_TOL, seed=17),
		"eigsh_trlan_la": lambda: ptt.eigsh(mesh, k=cs.EIG_K, which="LA", method="trlan", seed=17),
		"block_slq_trace": lambda: ptt.block_slq_trace(mesh, "exp", seed=17, t=-cs.BK_TAUS[0], **cs.BK),
		"filtered_eigsh": lambda: ptt.filtered_eigsh(gop, (0.0, b), k=cs.FE_COUNT, deg=deg, spectral_interval=(lo, hi), seed=17),
		"svds": lambda: ptt.svds(X, k=cs.SVD_K, maxiter=cs.EIG_MAXITER, tol=cs.EIG_TOL, seed=18),
		"gram_nuclear_xxt": lambda: ptt.hutch(nuc, batch=16, converge="count", count=16, seed=18),
	}
	for name, fn in calls.items():
		row = {"call": name, **trace(torch, fn)}
		print(json.dumps(row), flush=True)
		rows.append(row)
	smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
		capture_output=True, text=True, check=True, timeout=60).stdout.strip()
	with open(args.out, "w") as f:
		json.dump({"device": smi, "torch": torch.__version__, "calls": rows}, f, indent=1)
	print(smi, flush=True)


if __name__ == "__main__":
	main()
