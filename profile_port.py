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
``AAᵀ`` Gram side) of the rectangular data operator; and three recipes of its phase 19 at their
defaults: ``recipes.logdet`` (``orth=5``: pass A and the CGS window's chain of kernels) and
``recipes.trace_bounds`` (full re-orthogonalisation) on the mesh, and
``recipes.trace_inv(method="cg", precond="jacobi")`` on ``separated_spectrum``
(``--recipes`` traces these three alone). ``--grad`` traces phase 20's first call alone: the
gradient of ``Σ W∘MatrixFunction(L, exp(−x), deg=20, orth=0).matmat(V)`` with respect to the
mesh's bands, forward and backward, 64 probes. ``--sharded`` traces phase 23's 10M flagship alone,
on one NCCL rank through ``shard_operator(DIAOperator(L))`` (the sweep on the rank's rows: the step
kernels on the padded carry) and on the unsharded operator, and the global face's probe-major apply
of each, then
times by the host clock (synced, no trace) ``linalg.tall_qr`` of Hutch++'s (10M, 30) sketch block
and its parts (the Gram product, the Cholesky, the triangular solve). ``--bf16`` traces phase 24's 10M
full-bf16 flagship alone (a bf16 ``DIAOperator`` and ``MatrixFunction(..., dtype=bfloat16)``: pass A's
bf16 kernel and the round pair a step) beside the float32 flagship. ``--complex`` traces phase 15's β sweep
of ``tr e^{−βH}`` (4 × 48 steps) and its SLQ density (64 steps) alone, on the 4M-site complex64 Hofstadter
operator: the complex step kernels, passes A and B a step. ``--launch`` traces nothing: it times the launches of
two small kernels apart into host and device time (``chip_smoke.launch_times``: the host's enqueue of a burst, the
profiler's device time, CUDA events around one launch after a sync and over a burst) for ``lanczos_dia_advance`` (64 probes) and
``bsr_spmm`` where V fits in L2 (complex128 and complex64 at ``block_random_spd(8192)``, float32 at phase 20's
131,072 rows, k = 64) and at the BSR cell (float32, bfloat16, complex64, k = 64), each beside its least-traffic bound;
then the sweeps that launch the advance (``sharded_walls``): phase 23's 10M flagship sharded on one NCCL rank and
unsharded, in float32 and bfloat16 (traced, and three synced walls), and the flagship at 500k through the halo DIA
operator on two gloo ranks (meshes (2, 1) and (1, 2); bf16 on (2, 1)), each with its launches a sweep. Run it in
two checkouts in turns to compare them (copy this file and chip_smoke.py into the other checkout: the mode calls
only what every checkout of the package has). ``--against DIR`` (repeatable) traces nothing:
it times pass A (``pass_a_turns``: bf16 at 500k and 10M rounded, and 10M unrounded on the padded carry in the
finishing mode, beside the float32/float64/complex rows), the probe-major stencil (``stencil_t_turns``: bf16 at
64 × 500k and 64 × 10M with 3 diagonals and at the FEM cell, float32/float64, complex64) and the node-major stencil
(``stencil_turns``) and ``bsr_spmm`` (``bsr_turns``: complex128 and complex64 where V fits in L2, float32 at phase
20's operator, the BSR cell in float32, bf16 and complex64) of this tree and of each checkout ``DIR`` in turns at the
paths' shapes, pass A on the padded carry also with a pending finish (this tree's row-sharded step), and prints
``-Xptxas -v``'s registers and spills for each build's pass A, stencil, B2 and BSR kernels.
Prints one JSON line per call: the
traced host wall (ms), the summed device time of its kernels (ms), the device's
busy share of the wall, and the kernels that take the most device time (ms and
count); writes them all to ``--out``. Needs a CUDA device; without one it exits
non-zero.
"""

import argparse
import functools
import json
import re
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
	ap.add_argument("--recipes", action="store_true", help="trace the phase-19 recipes only")
	ap.add_argument("--grad", action="store_true", help="trace phase 20's differentiated f(A)V only")
	ap.add_argument("--sharded", action="store_true", help="trace phase 23's sharded flagship only; time tall_qr at 10M")
	ap.add_argument("--bf16", action="store_true", help="trace phase 24's 10M full-bf16 flagship (and the float32 one) only")
	ap.add_argument("--complex", action="store_true", help="trace phase 15's complex β sweep and SLQ density only")
	ap.add_argument("--launch", action="store_true", help="host and device time of the advance and of bsr_spmm, and the sharded sweeps' walls")
	ap.add_argument("--against", action="append", default=[], metavar="DIR",
		help="time pass A and the node-major stencil of this tree and of the checkout DIR in turns, and compare their outputs (no trace)")
	args = ap.parse_args()
	import torch

	if not torch.cuda.is_available():
		sys.exit("profile_port: torch.cuda.is_available() is False; this script needs an NVIDIA GPU")
	import chip_smoke as cs
	import primate_tpu_torch as ptt

	dev = torch.device("cuda", 0)
	only = args.recipes or args.grad or args.sharded or args.bf16 or args.complex or args.against or args.launch
	rows = [] if only else other_calls(torch, ptt, cs, dev)
	if args.launch:
		rows, calls = launch_yardstick(torch, ptt, cs, dev) + sharded_walls(torch, ptt, cs, dev), {}
	elif args.against:
		libs, rows = build_libs(args.against)
		bsr_libs, bsr_rows = build_libs(args.against, "bsr_spmm")
		rows, calls = rows + bsr_rows + pass_a_turns(torch, ptt, cs, dev, libs) + stencil_t_turns(torch, ptt, cs, dev, libs) + stencil_turns(
			torch, ptt, cs, dev, libs) + bsr_turns(torch, ptt, cs, dev, bsr_libs), {}
	elif args.complex:
		calls = complex_calls(torch, ptt, cs, dev)
	elif args.bf16:
		calls = {}
		for dt in (torch.bfloat16, torch.float32):
			op = ptt.DIAOperator.from_scipy(cs.build_laplacian(cs.N_LARGE), dtype=dt, device=dev)
			M = ptt.MatrixFunction(op, fun="log", deg=cs.DEG, orth=cs.ORTH, reorth_passes=1, dtype=dt)
			calls[f"flagship_{cs.N_LARGE}_{str(dt).removeprefix('torch.')}"] = functools.partial(
				ptt.hutch, M, batch=cs.PROBES, converge="count", count=cs.PROBES, seed=42
			)
	elif args.sharded:
		calls = sharded_calls(torch, ptt, cs, dev)
	elif args.grad:
		mesh = ptt.DIAOperator.from_scipy(cs.mesh_laplacian(cs.MESH_SIDE), dtype=torch.float32, device=dev)
		calls = {"grad_fav_mesh": grad_call(torch, ptt, cs, dev, mesh)}
	else:
		mesh = ptt.DIAOperator.from_scipy(cs.mesh_laplacian(cs.MESH_SIDE), dtype=torch.float32, device=dev)
		sep, _ = cs.separated_spectrum(cs.MESH_SIDE**2, cs.EIG_K, seed=17)
		sop = ptt.DIAOperator.from_scipy(sep, dtype=torch.float32, device=dev)
		rec = ptt.recipes
		calls = {  # chip_smoke.py phase 19
			"recipe_logdet_mesh": lambda: rec.logdet(mesh, seed=cs.REC_SEED),
			"recipe_trace_bounds_mesh": lambda: rec.trace_bounds(mesh, "log", nv=32, seed=cs.REC_SEED),
			"recipe_trace_inv_cg_jacobi": lambda: rec.trace_inv(sop, method="cg", precond="jacobi", rtol=cs.REC_RTOL, seed=cs.REC_SEED),
		}
	for name, fn in calls.items():
		row = {"call": name, **trace(torch, fn, top=16 if args.grad else 8)}
		print(json.dumps(row), flush=True)
		rows.append(row)
	if args.sharded:
		rows += tall_qr_walls(torch, cs, dev)
	smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
		capture_output=True, text=True, check=True, timeout=60).stdout.strip()
	with open(args.out, "w") as f:
		json.dump({"device": smi, "torch": torch.__version__, "calls": rows}, f, indent=1)
	print(smi, flush=True)


def _ptxas(nvcc: str, err: str) -> list:
	"""The lines of ``nvcc -Xptxas -v``'s report (``err``) on the pass A kernels, the two stencils (the probe-major
	``dia_stencil_t`` kernels, the node-major ``dia_stencil_kernel``), B2 and the BSR kernels: registers, spills,
	shared memory."""
	from pathlib import Path

	filt, rows, name = Path(nvcc).with_name("cu++filt"), [], None
	for line in err.splitlines():
		m = re.search(r"Compiling entry function '([^']+)'", line)
		if m:
			name = m.group(1)
			if filt.exists():
				name = subprocess.run([str(filt), name], capture_output=True, text=True).stdout.strip()
				name = name[: name.find(">(") + 1] if ">(" in name else name
		elif name and any(k in name for k in ("lanczos_pass_a", "dia_stencil", "bsr_spmm", "round_write")) and (
			"spill" in line or "Used" in line
		):
			rows.append(f"{name}: {line.strip()}")
	return rows


def build_libs(dirs, stem: str = "dia_stencil") -> tuple:
	"""``csrc/<stem>.cu`` of this tree and of each checkout in ``dirs``, built by nvcc with ``-Xptxas -v`` (one
	process each, started together) and loaded: ``[(tree, lib)]``, and the ptxas rows. The pass A, stencil and
	BSR entry points keep their C interface across checkouts, but for ``bsr_spmm``'s ``l2`` argument (``bsr_turns``
	calls a build without it the old way)."""
	import ctypes
	import os
	from pathlib import Path

	from primate_tpu_torch.ops import _build

	nvcc, jobs, libs, rows = _build.nvcc_path(), [], [], []
	_build._BUILD_DIR.mkdir(parents=True, exist_ok=True)
	for i, tree in enumerate(["this", *dirs]):
		src = Path(__file__).resolve().parent if tree == "this" else Path(tree).resolve()
		so = _build._BUILD_DIR / f"libturns_{stem}{i}.{os.getpid()}.so"
		cmd = [nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(so), str(src / "primate_tpu_torch" / "csrc" / f"{stem}.cu")]
		jobs.append((tree, so, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
	for tree, so, proc in jobs:
		err = proc.communicate()[1]
		if proc.returncode != 0:
			sys.exit(f"profile_port: nvcc failed for {tree}:\n{err}")
		lib = ctypes.CDLL(str(so))
		so.unlink()
		_build._declare(lib, stem)
		libs.append((tree, lib))
		rows.append({"ptxas": tree, "lines": _ptxas(nvcc, err)})
		print(json.dumps(rows[-1]), flush=True)
	return libs, rows


def _turns(torch, cs, row: dict, ents: list, others=(), reps: int = 20) -> dict:
	"""Fills ``row["libs"]`` from ``ents``, one ``(tree, launch, out, fields)`` a library, and prints ``row``:
	each ``out`` compared bit for bit (by part where complex) with every other entry's and with ``others``
	(``[(name, tensor)]``); then the libraries take turns (in order, then back), ``reps`` launches each by
	CUDA events, and each gets its mean and its share of ``row["bound_ms"]``."""
	parts = lambda t: torch.view_as_real(t).unbind(-1) if t.is_complex() else (t,)  # noqa: E731
	outs = [(tree, o) for tree, _, o, _ in ents] + list(others)
	row["libs"] = {tree: {**fields, "entries_differing_in_bits": {t: [int((x != y).sum()) for x, y in zip(parts(o), parts(o2))]
		for t, o2 in outs if t != tree}, "ms": []} for tree, _, o, fields in ents}
	del outs
	for turn in (range(len(ents)), reversed(range(len(ents)))):
		for i in turn:
			row["libs"][ents[i][0]]["ms"].append(cs.time_ms(torch, ents[i][1], reps))
	for v in row["libs"].values():
		v["mean_ms"] = sum(v["ms"]) / len(v["ms"])
		v["share_of_bound"] = row["bound_ms"] / v["mean_ms"]
	print(json.dumps(row), flush=True)
	return row


def pass_a_turns(torch, ptt, cs, dev, libs, reps: int = 20) -> list:
	"""Pass A in the sweep's mode (the state's divisors and β, the ticket, α written by the last block),
	from each library of ``build_libs`` (this tree's ``csrc/dia_stencil.cu`` and each checkout's, the same
	C interface for pass A) launched through this tree's wrappers on the same inputs, at the paths'
	shapes: phase 15's Hofstadter cell (16 × 4,096,000, 8 diagonals) in complex64 and complex128; the
	flagship's ``tridiag(-1, 3, -1)``, 64 probes, at 500k and 10M in float32 and float64, float32 10M also
	on the padded carry in the row-sharded mode, and bfloat16 rounded at 10M (the full-bf16 flagship's
	step). Per shape the libraries take turns (``_turns``); every library's ``w`` is compared bit for bit
	with every other's, and its α with this tree's."""
	from primate_tpu_torch.ops import dia

	rows = []
	gen = torch.Generator(device=dev)
	gen.manual_seed(16)

	def block(nv, n, dtype):
		if dtype.is_complex:
			X = torch.view_as_complex(torch.randn((nv, n, 2), generator=gen, device=dev, dtype=dtype.to_real()))
		else:
			X = torch.randn((nv, n), generator=gen, device=dev, dtype=torch.float32 if dtype == torch.bfloat16 else dtype)
		return (X / torch.linalg.vector_norm(X, dim=1, keepdim=True)).to(dtype)

	def run(label, bands, offs, v_cur, v_prev, r, bytes_, spec=None, rounded=True, finish=False):
		nv = v_cur.shape[0]
		st0 = dia.lanczos_state(nv, r, dev)
		for k in (dia.DIV_CUR, dia.DIV_PREV, dia.BETA):
			st0.scal[k] = torch.rand(nv, generator=gen, device=dev, dtype=r) + 0.5
		if finish:  # one power of two a probe for both divisors and β: the pending finish below leaves them as they are
			c = torch.exp2(torch.randint(-2, 3, (nv,), generator=gen, device=dev)).to(r)
			st0.scal[dia.DIV_CUR] = st0.scal[dia.DIV_PREV] = st0.scal[dia.BETA] = c
		ents, a0 = [], None
		for tree, lib in libs:
			st = dia.LanczosState(st0.scal.clone(), torch.zeros(1, dtype=torch.int32, device=dev))
			sums = torch.zeros(nv, dtype=r, device=dev) if spec is not None else None
			launch = functools.partial(dia._launch_pass_a, lib, bands, offs, v_cur, v_prev, st.scal, st.ticket, None, spec, sums, rounded)
			w, _, gx, vec = launch()
			torch.cuda.synchronize()
			alpha = sums if spec is not None else st.scal[dia.ALPHA].clone()
			a0 = alpha if a0 is None else a0
			ents.append((tree, launch, w, {"alpha_max_rel_diff": float(((alpha - a0).abs() / a0.abs().clamp_min(1e-30)).max()),
				"grid_x": gx}))
		for tree, lib in libs if finish else ():  # pass A with the step before's finish pending (the row-sharded step)
			if not hasattr(lib, "lanczos_dia_step_finish_f32"):
				continue
			st = dia.LanczosState(st0.scal.clone(), torch.zeros(1, dtype=torch.int32, device=dev))
			fin = dia.Finish(torch.stack([torch.randn(nv, generator=gen, device=dev, dtype=r), st0.scal[dia.DIV_CUR] ** 2]),
				torch.empty(nv, dtype=r, device=dev), torch.empty(nv, dtype=r, device=dev), 1e-8)
			sums = torch.zeros(nv, dtype=r, device=dev)
			launch = functools.partial(dia._launch_pass_a, lib, bands, offs, v_cur, v_prev, st.scal, st.ticket, None, spec, sums, rounded,
				fin)
			w, _, gx, _ = launch()
			torch.cuda.synchronize()
			ents.append((f"{tree}_with_finish", launch, w, {"alpha_max_rel_diff": float(((sums - a0).abs() / a0.abs().clamp_min(1e-30)).max()),
				"grid_x": gx}))
		rows.append(_turns(torch, cs, {"shape": label, "nv": nv, "ld": v_cur.shape[1], "dtype": str(v_cur.dtype).removeprefix("torch."),
			"rounded": rounded, "vector_path": vec, "bound_ms": bytes_ / cs.HBM_BYTES_PER_S * 1e3}, ents, reps=reps))
		del ents
		torch.cuda.empty_cache()

	H = ptt.DIAOperator.from_scipy(cs.hofstadter_csr(**cs.TB), dtype=torch.complex64, device=dev)
	n, n_d, nv = H.shape[0], len(H.offsets), cs.TB_NV
	for dtype, key in ((torch.complex64, "c64"), (torch.complex128, "c128")):
		item = 8 if dtype == torch.complex64 else 16
		run(f"{key}_cell", H.bands.to(dtype), H.offsets_t, block(nv, n, dtype), block(nv, n, dtype), dtype.to_real(),
			(3 * nv * n + n_d * n) * item)
	del H
	nv = cs.PROBES
	for n, tag in ((cs.N_FLAGSHIP, "500k"), (cs.N_LARGE, "10M")):
		for dtype, key in ((torch.float32, "f32"), (torch.float64, "f64")):
			op = ptt.DIAOperator.from_scipy(cs.build_laplacian(n), dtype=dtype, device=dev)
			v_cur, v_prev, item = block(nv, n, dtype), block(nv, n, dtype), dtype.itemsize
			run(f"{key}_{tag}", op.bands, op.offsets_t, v_cur, v_prev, dtype, (3 * nv * n + 3 * n) * item)
			if dtype == torch.float32 and n == cs.N_LARGE:
				spec = op.carry_spec(nv)
				cb, vc, vp = op._carry_bands(spec), spec.pad(v_cur), spec.pad(v_prev)
				del v_cur, v_prev
				run(f"{key}_{tag}_padded", cb, op.offsets_t, vc, vp, dtype, (3 * nv * n + 3 * n) * item, spec, finish=True)
				del cb, vc, vp
			del op
	for n, tag in ((cs.N_FLAGSHIP, "500k"), (cs.N_LARGE, "10M")):
		op = ptt.DIAOperator.from_scipy(cs.build_laplacian(n), dtype=torch.bfloat16, device=dev)
		v_cur, v_prev, bytes_ = block(nv, n, torch.bfloat16), block(nv, n, torch.bfloat16), (2 * nv * n + 3 * n) * 2 + nv * n * 4
		run(f"bf16_{tag}", op.bands, op.offsets_t, v_cur, v_prev, torch.float32, bytes_)
		if n == cs.N_LARGE:  # the sharded and phys=True sweeps' step: unrounded, on the padded carry, the rank's sums
			spec = op.carry_spec(nv)
			cb, vc, vp = op._carry_bands(spec), spec.pad(v_cur), spec.pad(v_prev)
			del v_cur, v_prev
			run(f"bf16_{tag}_padded", cb, op.offsets_t, vc, vp, torch.float32, bytes_, spec, rounded=False)
			del cb, vc, vp
		del op
	return rows


def _bsr_launcher(lib, blocks, indptr, indices, V, n: int):
	"""``bsr_spmm`` of ``lib`` (a build of any checkout's ``csrc/bsr_spmm.cu``) on these arrays, as a call that returns
	its output, and whether it takes the L2 path (where the build has one and takes the call)."""
	import torch

	from primate_tpu_torch.ops import _common

	nnzb, bm, bn = blocks.shape
	m, k = V.shape
	fn = getattr(lib, f"bsr_spmm_{_common.SUFFIX[V.dtype]}")
	l2 = hasattr(lib, "bsr_spmm_l2_path") and V.dtype == torch.complex128 and bool(lib.bsr_spmm_l2_path(bm, bn, m, k))

	def launch():
		out = torch.empty((n, k), dtype=V.dtype, device=V.device)
		vec = _common.vector_ok(k, V.element_size(), blocks, V, out)
		err = fn(blocks.data_ptr(), indptr.data_ptr(), indices.data_ptr(), V.data_ptr(), out.data_ptr(), indptr.shape[0] - 1, bm, bn, m,
			k, n, int(vec), _common.stream(V.device))
		_common.raise_on(lib, err, "bsr_spmm")
		return out

	return launch, l2


def bsr_turns(torch, ptt, cs, dev, libs, reps: int = 20) -> list:
	"""``bsr_spmm`` of each library of ``build_libs(..., "bsr_spmm")`` on the same inputs at k = 64: complex128 and
	complex64 at ``block_random_spd(CBSR_C128_N)`` with seeded imaginary tiles (phase 21's small shape; V in L2), float32
	at phase 20's 131,072 rows, and float32, bfloat16 and complex64 at the BSR cell; each beside its least-traffic
	bound, the outputs compared bit for bit, and each library's error against the plain version."""
	from primate_tpu_torch.ops import bsr

	rows = []
	gen = torch.Generator(device=dev)
	gen.manual_seed(19)
	As = ptt.BSROperator.from_scipy(cs._bsr_cell(n=cs.CBSR_C128_N, bs=8, density=0.01, seed=cs.CBSR_SEED), blocksize=(8, 8),
		dtype=torch.float64, device=dev)
	im = torch.randn(As.blocks.shape, generator=gen, device=dev, dtype=torch.float64)
	shapes = [(f"c128_{cs.CBSR_C128_N}", As, lambda: torch.complex(As.blocks, im), torch.complex128),
		(f"c64_{cs.CBSR_C128_N}", As, lambda: torch.complex(As.blocks, im).to(torch.complex64), torch.complex64)]
	Ag = ptt.BSROperator.from_scipy(cs._bsr_cell(**cs.GRAD_BSR), blocksize=(8, 8), dtype=torch.float32, device=dev)
	shapes.append((f"f32_{cs.GRAD_BSR['n']}", Ag, lambda: Ag.blocks, torch.float32))
	A = ptt.BSROperator.from_scipy(cs._bsr_cell(**cs.BSR_CELL), blocksize=(8, 8), dtype=torch.float32, device=dev)
	shapes += [("f32_cell", A, lambda: A.blocks, torch.float32), ("bf16_cell", A, lambda: A.blocks.to(torch.bfloat16), torch.bfloat16),
		("c64_cell", A, lambda: torch.complex(A.blocks, 0.01 * torch.randn(A.blocks.shape, generator=gen, device=dev)), torch.complex64)]
	k = 64
	for label, op, make, dt in shapes:
		blocks, n = make(), op.shape[0]
		V = torch.randn((n, k), generator=gen, device=dev, dtype=dt)
		item = V.element_size()
		peak = cs.FP64_FLOP_PER_S if dt == torch.complex128 else cs.BF16_FLOP_PER_S if dt == torch.bfloat16 else cs.FP32_FLOP_PER_S
		b_ms, b_by = cs.bound((blocks.numel() + 2 * n * k) * item, (8 if dt.is_complex else 2) * blocks.numel() * k, peak)
		want = bsr.bsr_spmm_ref(blocks, op.indptr, op.indices, V, n)
		ents = []
		for tree, lib in libs:
			launch, l2 = _bsr_launcher(lib, blocks, op.indptr, op.indices, V, n)
			out = launch()
			torch.cuda.synchronize()
			ents.append((tree, launch, out, {"l2_path": l2, "rel_err": float((out - want).abs().max() / want.abs().max())}))
		del want
		rows.append(_turns(torch, cs, {"shape": label, "k": k, "dtype": str(dt).removeprefix("torch."), "tiles": int(blocks.shape[0]),
			"bound_ms": b_ms, "bound_by": b_by}, ents, reps=reps))
		del ents, blocks, V
		torch.cuda.empty_cache()
	return rows


def stencil_t_turns(torch, ptt, cs, dev, libs, reps: int = 20) -> list:
	"""The probe-major stencil (``dia_stencil_t``) of each library of ``build_libs`` on the same inputs: bfloat16
	at 64 × 500k with the flagship's 3 diagonals (phase 24's plain trace), at 64 × 10M with the same 3 (on no
	path: it tells a fixed cost a launch from a cost a byte) and at the FEM cell ``fem_laplacian_3d(100)`` (64 × 1M,
	7 diagonals, one chunk); float32 and float64 at 64 × 500k and float32 at the FEM cell; complex64 at phase 15's
	Hofstadter cell (16 × 4,096,000, 8 diagonals). Per shape the libraries take turns (``_turns``); each output is
	compared bit for bit with every other library's and with the plain version's on the card."""
	from benchmarks.matrices import fem_laplacian_3d
	from primate_tpu_torch.ops import _common, dia

	gen = torch.Generator(device=dev)
	gen.manual_seed(18)
	rows = []

	def run(label, bands, offs, X):
		(nv, n), item, n_d = X.shape, X.element_size(), bands.shape[0]
		vec = _common.vector_ok(n, item, X)
		ents = []
		for tree, lib in libs:
			o = torch.empty_like(X)
			fn = getattr(lib, f"dia_stencil_t_{_common.SUFFIX[X.dtype]}")

			def go(fn=fn, lib=lib, o=o):
				_common.raise_on(lib, fn(bands.data_ptr(), offs.data_ptr(), n_d, X.data_ptr(), o.data_ptr(), None, nv, n, int(vec),
					_common.stream(dev)), "dia_stencil_t")

			go()
			ents.append((tree, go, o, {}))
		rows.append(_turns(torch, cs, {"stencil_t": label, "nv": nv, "n": n, "n_d": n_d, "dtype": str(X.dtype).removeprefix("torch."),
			"vector_path": vec, "bound_ms": (2 * nv * n + n_d * n) * item / cs.HBM_BYTES_PER_S * 1e3}, ents,
			[("plain", dia.dia_stencil_t_ref(bands, offs, X))], reps))
		del ents
		torch.cuda.empty_cache()

	nv = cs.PROBES
	for n, tag in ((cs.N_FLAGSHIP, "500k"), (cs.N_LARGE, "10M")):
		for dtype, key in ((torch.bfloat16, "bf16"), (torch.float32, "f32"), (torch.float64, "f64")):
			if n == cs.N_LARGE and dtype != torch.bfloat16:
				continue
			op = ptt.DIAOperator.from_scipy(cs.build_laplacian(n), dtype=dtype, device=dev)
			run(f"{key}_{tag}", op.bands, op.offsets_t, torch.randn((nv, n), generator=gen, device=dev).to(dtype))
			del op
	A = fem_laplacian_3d(cs.FEM_SIDE)
	for dtype, key in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
		D = ptt.DIAOperator.from_scipy(A, dtype=dtype, device=dev)
		run(f"{key}_fem", D.bands, D.offsets_t, torch.randn((nv, D.shape[0]), generator=gen, device=dev).to(dtype))
		del D
	H = ptt.DIAOperator.from_scipy(cs.hofstadter_csr(**cs.TB), dtype=torch.complex64, device=dev)
	run("c64_cell", H.bands, H.offsets_t, torch.view_as_complex(torch.randn((cs.TB_NV, H.shape[0], 2), generator=gen, device=dev)))
	return rows


def stencil_turns(torch, ptt, cs, dev, libs, reps: int = 20) -> list:
	"""The node-major stencil (``dia_stencil``) of each library of ``build_libs`` on the same inputs, at the
	paths' shapes: phase 15's Hofstadter cell (4,096,000 × 64, 8 diagonals) in complex64 and complex128; the
	FEM cell ``fem_laplacian_3d(100)`` (1M × 64, 7 diagonals) in bfloat16, float32 and float64, and float32
	at k = 240; phase 17's LOBPCG block on the 1M mesh (1M × 10, float32: the element path). Per shape the
	libraries take turns (``_turns``); each output is compared bit for bit with every other library's and
	with the plain version's on the card."""
	from benchmarks.matrices import fem_laplacian_3d
	from primate_tpu_torch.ops import _common, dia

	gen = torch.Generator(device=dev)
	gen.manual_seed(17)
	rows = []

	def run(label, bands, offs, V):
		(n, k), item, n_d = V.shape, V.element_size(), bands.shape[0]
		vec = _common.vector_ok(k, item, V)
		ents = []
		for tree, lib in libs:
			o = torch.empty_like(V)
			fn = getattr(lib, f"dia_stencil_{_common.SUFFIX[V.dtype]}")

			def go(fn=fn, lib=lib, o=o):
				_common.raise_on(lib, fn(bands.data_ptr(), offs.data_ptr(), n_d, V.data_ptr(), o.data_ptr(), n, k, int(vec),
					_common.stream(dev)), "dia_stencil")

			go()
			ents.append((tree, go, o, {}))
		rows.append(_turns(torch, cs, {"stencil": label, "n": n, "k": k, "n_d": n_d, "dtype": str(V.dtype).removeprefix("torch."),
			"vector_path": vec, "bound_ms": (2 * n * k + n_d * n) * item / cs.HBM_BYTES_PER_S * 1e3}, ents,
			[("plain", dia.dia_stencil_ref(bands, offs, V))], reps))
		del ents
		torch.cuda.empty_cache()

	def crandn(shape, dtype):
		return torch.view_as_complex(torch.randn(tuple(shape) + (2,), generator=gen, device=dev, dtype=dtype.to_real()))

	H = ptt.DIAOperator.from_scipy(cs.hofstadter_csr(**cs.TB), dtype=torch.complex64, device=dev)
	for dtype, key in ((torch.complex64, "c64"), (torch.complex128, "c128")):
		run(f"{key}_cell", H.bands.to(dtype), H.offsets_t, crandn((H.shape[0], 64), dtype))
	del H
	A = fem_laplacian_3d(cs.FEM_SIDE)
	for dtype, key, k in ((torch.bfloat16, "bf16", 64), (torch.float32, "f32", 64), (torch.float64, "f64", 64), (torch.float32, "f32", 240)):
		D = ptt.DIAOperator.from_scipy(A, dtype=dtype, device=dev)
		run(f"{key}_fem_k{k}", D.bands, D.offsets_t, torch.randn((D.shape[0], k), generator=gen, device=dev).to(dtype))
		del D
	M = ptt.DIAOperator.from_scipy(cs.mesh_laplacian(cs.MESH_SIDE), dtype=torch.float32, device=dev)
	run("f32_mesh_k10", M.bands, M.offsets_t, torch.randn((M.shape[0], 10), generator=gen, device=dev))
	return rows


def complex_calls(torch, ptt, cs, dev) -> dict:
	"""``chip_smoke.py`` phase 15's two complex sweeps on the 4M-site Hofstadter operator (complex64 DIA):
	the β sweep ``hutch(MatrixFunction(H, stacked("exp", −β)), deg=48)`` on 4 batches of 16 phase probes,
	and ``spectral_density(H, deg=64)`` on 16."""
	H = ptt.DIAOperator.from_scipy(cs.hofstadter_csr(**cs.TB), dtype=torch.complex64, device=dev)
	sweep = ptt.MatrixFunction(H, ptt.stacked("exp", -np.array(cs.TB_BETAS)), deg=48, orth=0)
	return {
		"tb_beta_sweep": lambda: ptt.hutch(sweep, pdf="phase", batch=16, converge="count", count=64, seed=155),
		"tb_spectral_density": lambda: ptt.spectral_density(H, deg=64, nv=cs.TB_NV, seed=158),
	}


def sharded_calls(torch, ptt, cs, dev) -> dict:
	"""``chip_smoke.py`` phase 23's flagship on one NCCL rank: the 10M flagship through the sharded DIA
	operator (the step kernels on its padded carry, α and β all-reduced between the passes), and the
	same call on the unsharded operator, traced in the same process; and the probe-major global face
	(``matmat_t`` of a replicated 64 × 10M block) of each."""
	from primate_tpu_torch.parallel import initialize_distributed, make_mesh, shard_operator

	torch.cuda.set_device(dev)
	initialize_distributed("nccl", init_method=f"tcp://localhost:{cs._free_port()}", world_size=1, rank=0)
	op = ptt.DIAOperator.from_scipy(cs.build_laplacian(cs.N_LARGE), dtype=torch.float32, device=dev)
	calls = {}
	X = torch.randn((cs.PROBES, cs.N_LARGE), device=dev)
	for name, o in (("sharded", shard_operator(op, make_mesh((1, 1)))), ("unsharded", op)):
		M = ptt.MatrixFunction(o, fun="log", deg=cs.DEG, orth=cs.ORTH, reorth_passes=1, dtype=torch.float32)
		calls[f"{name}_flagship_{cs.N_LARGE}"] = functools.partial(
			ptt.hutch, M, batch=cs.PROBES, converge="count", count=cs.PROBES, seed=42
		)
		calls[f"{name}_matmat_t_{cs.PROBES}x{cs.N_LARGE}"] = functools.partial(o.matmat_t, X)  # phase 23's global face
	return calls


def launch_yardstick(torch, ptt, cs, dev) -> list:
	"""``chip_smoke.launch_times`` of ``lanczos_dia_advance`` (64 probes, float32, from seeded sums) and of ``bsr_spmm`` at k = 64:
	complex128 and complex64 at ``block_random_spd(CBSR_C128_N)`` with seeded imaginary tiles (phase 21's small
	shape), float32 at phase 20's 131,072-row operator, and float32, bfloat16 and complex64 at the BSR cell (phase
	7's matrix; the complex tiles get a seeded imaginary part); each with its least-traffic bound (tiles, V and the
	output once: ``(nnzb·bm·bn + 2·n·k)·item`` over 3.35 TB/s, or the operations at the card's peak)."""
	from primate_tpu_torch.ops import bsr, dia
	from primate_tpu_torch.ops._build import load_library

	rows = []
	lib = load_library()
	gen = torch.Generator(device=dev)
	gen.manual_seed(19)
	nv = cs.PROBES
	sums = torch.rand((2, nv), generator=gen, device=dev) + 0.5
	st = dia.lanczos_state(nv, torch.float32, dev)
	ab = torch.empty((2, nv), device=dev)
	row = {"call": f"lanczos_dia_advance_nv{nv}", "bound_ms": cs.bound(11 * nv * 4, 6 * nv)[0],
		**cs.launch_times(torch, lambda: dia._launch_advance(lib, sums, st, ab[0], ab[1], 1e-8))}
	print(json.dumps(row), flush=True)
	rows.append(row)
	shapes = []
	Ss = cs._bsr_cell(n=cs.CBSR_C128_N, bs=8, density=0.01, seed=cs.CBSR_SEED)
	As = ptt.BSROperator.from_scipy(Ss, blocksize=(8, 8), dtype=torch.float64, device=dev)
	im = torch.randn(As.blocks.shape, generator=gen, device=dev, dtype=torch.float64)
	for dt in (torch.complex128, torch.complex64):
		blocks = torch.complex(As.blocks, im).to(dt)
		shapes.append((f"block_random_spd({cs.CBSR_C128_N})", As, blocks, dt))
	Sg = cs._bsr_cell(**cs.GRAD_BSR)
	Ag = ptt.BSROperator.from_scipy(Sg, blocksize=(8, 8), dtype=torch.float32, device=dev)
	shapes.append((f"block_random_spd({cs.GRAD_BSR['n']})", Ag, Ag.blocks, torch.float32))
	S = cs._bsr_cell(**cs.BSR_CELL)
	A = ptt.BSROperator.from_scipy(S, blocksize=(8, 8), dtype=torch.float32, device=dev)
	for dt in (torch.float32, torch.bfloat16, torch.complex64):
		shapes.append(("cell", A, A.blocks.to(dt) if not dt.is_complex else None, dt))
	k = 64
	for label, op, blocks, dt in shapes:
		if blocks is None:  # the cell's complex tiles, made when they are timed (683 MB)
			blocks = torch.complex(op.blocks, 0.01 * torch.randn(op.blocks.shape, generator=gen, device=dev))
		n = op.shape[0]
		V = torch.randn((n, k), generator=gen, device=dev, dtype=dt)
		args = (blocks, op.indptr, op.indices, V, n)
		item = V.element_size()
		real_ops = (8 if dt.is_complex else 2) * blocks.numel() * k
		peak = cs.FP64_FLOP_PER_S if dt == torch.complex128 else cs.BF16_FLOP_PER_S if dt == torch.bfloat16 else cs.FP32_FLOP_PER_S
		b_ms, b_by = cs.bound((blocks.numel() + 2 * n * k) * item, real_ops, peak)
		row = {"call": f"bsr_spmm_{str(dt).removeprefix('torch.')}_{label}_k{k}", "tiles": int(blocks.shape[0]), "n": n,
			"v_bytes": n * k * item, "bound_ms": b_ms, "bound_by": b_by, **cs.launch_times(torch, lambda: bsr.bsr_spmm(*args), 100)}
		row["share_of_bound_device"] = b_ms / row["device_ms"]
		print(json.dumps(row), flush=True)
		rows.append(row)
		del V, blocks, args
	torch.cuda.empty_cache()
	return rows


def _sweep_digest(torch, ptt, op, n: int, dtype, dev) -> str:
	"""A digest of the α and β bits of one ``lanczos_block_op`` sweep of ``op`` (deg ``chip_smoke.DEG``, orth 0) on a
	seeded Rademacher block of 64 probes: two checkouts whose digests agree computed the same α and β bit for bit."""
	import hashlib

	import chip_smoke as cs

	g = torch.Generator(device=dev)
	g.manual_seed(42)
	V = (torch.randint(0, 2, (n, cs.PROBES), generator=g, device=dev) * 2 - 1).to(dtype)
	res = ptt.lanczos_block_op(op, V, deg=cs.DEG, ncv=2, orth=0, return_basis=False)
	return hashlib.sha1(res.alphas.float().cpu().numpy().tobytes() + res.betas.float().cpu().numpy().tobytes()).hexdigest()


def _counted_walls(torch, fn, reps: int = 3) -> dict:
	"""The launches of one call of ``fn`` (after a warm-up), then ``reps`` synced walls (s)."""
	from primate_tpu_torch.ops import _common

	fn()
	torch.cuda.synchronize()
	_common.reset_launches()
	fn()
	torch.cuda.synchronize()
	launches = {k: v for k, v in _common.LAUNCHES.items() if v}
	walls = []
	for _ in range(reps):
		t0 = time.perf_counter()
		fn()
		torch.cuda.synchronize()
		walls.append(time.perf_counter() - t0)
	return {"launches": launches, "wall_s": walls, "wall_s_median": sorted(walls)[len(walls) // 2]}


def sharded_walls(torch, ptt, cs, dev) -> list:
	"""The sweeps that launch ``lanczos_dia_advance``: the 10M flagship through ``shard_operator`` on one NCCL rank and
	unsharded, in float32 and bfloat16 (one traced call, then the launches of a call and three synced walls), and
	the 500k flagship through the halo DIA operator on two gloo ranks on this card (subprocesses, ``--rank``); each
	with its estimate's bits and a digest of one sweep's α and β bits (``_sweep_digest``)."""
	import tempfile

	from primate_tpu_torch.parallel import initialize_distributed, make_mesh, shard_operator

	rows = []
	torch.cuda.set_device(dev)
	initialize_distributed("nccl", init_method=f"tcp://localhost:{cs._free_port()}", world_size=1, rank=0)
	for dt in (torch.float32, torch.bfloat16):
		op = ptt.DIAOperator.from_scipy(cs.build_laplacian(cs.N_LARGE), dtype=dt, device=dev)
		for name, o in (("sharded", shard_operator(op, make_mesh((1, 1)))), ("unsharded", op)):
			M = ptt.MatrixFunction(o, fun="log", deg=cs.DEG, orth=cs.ORTH, reorth_passes=1, dtype=dt)
			fn = functools.partial(ptt.hutch, M, batch=cs.PROBES, converge="count", count=cs.PROBES, seed=42)
			row = {"call": f"{name}_flagship_{cs.N_LARGE}_{str(dt).removeprefix('torch.')}", **trace(torch, fn), **_counted_walls(torch, fn)}
			row["estimate_hex"] = float(fn()).hex()
			row["alpha_beta_sha1"] = _sweep_digest(torch, ptt, o, cs.N_LARGE, dt, dev)
			print(json.dumps(row), flush=True)
			rows.append(row)
			del M, fn
		del op, o
		torch.cuda.empty_cache()
	torch.distributed.destroy_process_group()
	for dtype in ("float32", "bfloat16"):
		with tempfile.TemporaryDirectory() as tmp:
			procs = [subprocess.Popen([sys.executable, __file__, "--rank", str(r), "2", f"{tmp}/store", dtype], stdout=subprocess.PIPE,
				stderr=subprocess.PIPE, text=True) for r in range(2)]
			outs = [p.communicate(timeout=cs.SHARD_TIMEOUT_S) for p in procs]
		for p, (out, err) in zip(procs, outs):
			if p.returncode != 0:
				sys.exit(f"profile_port: a gloo rank failed ({p.returncode}):\n{out[-2000:]}\n{err[-4000:]}")
		for r, (out, _) in enumerate(outs):
			for line in out.splitlines():
				if line.startswith("{"):
					row = json.loads(line)
					print(json.dumps(row), flush=True)
					rows.append(row)
	return rows


def gloo_rank(rank: int, world: int, store: str, dtype: str) -> None:
	"""One rank of ``sharded_walls``' gloo sweeps: the flagship at ``SHARD_N`` through the halo DIA operator on cuda:0,
	on the (world, 1) and (1, world) meshes (bfloat16: (world, 1) alone), a warm-up call, then its launches and
	three synced walls; prints a JSON line each."""
	import gc

	import torch

	import chip_smoke as cs
	import primate_tpu_torch as ptt
	from primate_tpu_torch.parallel import initialize_distributed, make_mesh, shard_operator

	dev = torch.device("cuda", 0)
	torch.cuda.set_device(dev)
	initialize_distributed("gloo", init_method=f"file://{store}", world_size=world, rank=rank)
	dt = getattr(torch, dtype)

	def calls():
		L = cs.build_laplacian(cs.SHARD_N)
		for shape in ((world, 1), (1, world)) if dt == torch.float32 else ((world, 1),):
			op = shard_operator(ptt.DIAOperator.from_scipy(L, dtype=dt, device="cpu"), make_mesh(shape, ("op", "probe"), device_type="cuda"),
				probe_axis="probe", device=dev)
			M = ptt.MatrixFunction(op, fun="log", deg=cs.DEG, orth=cs.ORTH, reorth_passes=1, dtype=dt)
			fn = functools.partial(ptt.hutch, M, batch=cs.PROBES, converge="count", count=cs.PROBES, seed=42)
			print(json.dumps({"call": f"gloo_flagship_{cs.SHARD_N}_{dtype}", "rank": rank, "world": world, "mesh": list(shape),
				**_counted_walls(torch, fn), "estimate_hex": float(fn()).hex(), "alpha_beta_sha1": _sweep_digest(torch, ptt, op, cs.SHARD_N, dt, dev)}),
				flush=True)

	calls()
	gc.collect()
	torch.distributed.barrier()
	torch.distributed.destroy_process_group()


def tall_qr_walls(torch, cs, dev, m: int = 30) -> list:
	"""Host walls (synced, one call each after a warm-up) of ``linalg.tall_qr`` on an (N_LARGE, m)
	float32 block, the path Laplacian applied to Rademacher probes (Hutch++'s sketch), and of its
	parts: ``Yᵀ Y``, the Cholesky of the shifted Gram matrix, the triangular solve."""
	from primate_tpu_torch.linalg import tall_qr

	gen = torch.Generator(device=dev)
	gen.manual_seed(23)
	W = torch.randint(0, 2, (cs.N_LARGE, m), generator=gen, device=dev).float() * 2 - 1
	Y = 3 * W - torch.roll(W, 1, 0) - torch.roll(W, -1, 0)
	del W
	G = Y.T @ Y
	L = torch.linalg.cholesky(G + 1e-3 * torch.linalg.matrix_norm(G) * torch.eye(m, device=dev))
	parts = {
		"tall_qr": lambda: tall_qr(Y),
		"gram_YtY": lambda: Y.T @ Y,
		"cholesky_ex": lambda: torch.linalg.cholesky_ex(G),
		"solve_triangular": lambda: torch.linalg.solve_triangular(L, Y.T, upper=False),
	}
	rows = []
	for name, fn in parts.items():
		fn()
		torch.cuda.synchronize()
		t0 = time.perf_counter()
		fn()
		torch.cuda.synchronize()
		row = {"call": f"{name}_{cs.N_LARGE}x{m}", "wall_ms": (time.perf_counter() - t0) * 1e3}
		print(json.dumps(row), flush=True)
		rows.append(row)
	return rows


def grad_call(torch, ptt, cs, dev, mesh):
	"""``chip_smoke.py`` phase 20's first call: F's value and its gradient with respect to the
	mesh's bands (64 probes, deg 20, orth 0, two-pass), as one function for ``trace``."""
	gen = torch.Generator(device=dev)
	gen.manual_seed(cs.GRAD["seed"])
	n, k = mesh.shape[0], cs.GRAD["probes"]
	V = torch.randn((n, k), generator=gen, device=dev, dtype=torch.float32)
	W = torch.randn((n, k), generator=gen, device=dev, dtype=torch.float32)

	def fn():
		b = mesh.bands.clone().requires_grad_(True)
		op = ptt.DIAOperator(b, mesh.offsets, mesh.shape)
		F = torch.sum(W * ptt.MatrixFunction(op, "exp", t=-1.0, deg=cs.GRAD["deg"], orth=0).matmat(V))
		F.backward()
		return b.grad

	return fn


def other_calls(torch, ptt, cs, dev) -> list:
	"""The traces of phases 3-18's calls, printed as they are taken; returns their rows."""
	from benchmarks.matrices import block_random_spd

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
	return rows


if __name__ == "__main__":
	if sys.argv[1:2] == ["--rank"]:
		gloo_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
	else:
		main()
