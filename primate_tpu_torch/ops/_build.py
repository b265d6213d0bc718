"""Build and load the hand-written CUDA kernels of ``csrc/`` (plain C interface, ctypes).

Counterpart of the build pattern in ``primate_tpu/native/__init__.py``: the sources
compile at first use, never at import. Each ``csrc/*.cu`` becomes its own shared
library, and all of them compile at once, one nvcc process per source. A
library's file name carries a digest of its source, the shared headers and the
flags, so an edited source rebuilds. Each compile writes a per-process temp
file and renames it atomically, so concurrent processes (xdist workers, several
launches) never load a half-written library. Unlike the JAX package's host
helper there is no fallback: a build or load failure raises.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

__all__ = ["NVCC_FLAGS", "build_library", "load_library", "nvcc_path"]

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC")

_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
	"""The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH, else the toolkit's default place."""
	cands = []
	if os.environ.get("CUDA_HOME"):
		cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
	cands += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
	for c in cands:
		if c and os.path.isfile(c) and os.access(c, os.X_OK):
			return c
	raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); the CUDA kernels cannot be built")


def _sources() -> list:
	return sorted(_CSRC.glob("*.cu"))


def _digest(src: Path) -> str:
	h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
	for p in [src, *sorted(_CSRC.glob("*.cuh"))]:
		h.update(p.name.encode())
		h.update(p.read_bytes())
	return h.hexdigest()[:16]


def _library_path(src: Path) -> Path:
	return _BUILD_DIR / f"lib{src.stem}.{_digest(src)}.so"


def build_library() -> Dict[str, Path]:
	"""Compile every ``csrc/*.cu`` for sm_90a that has no library for its current
	source, all in parallel; return ``{source stem: library path}``."""
	libs = {src.stem: _library_path(src) for src in _sources()}
	todo = {stem: so for stem, so in libs.items() if not so.exists()}
	if not todo:
		return libs
	_BUILD_DIR.mkdir(parents=True, exist_ok=True)
	nvcc, jobs = nvcc_path(), []
	try:
		for stem, so in todo.items():
			tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
			cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / f"{stem}.cu")]
			jobs.append((so, tmp, cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
		errors = []
		for so, tmp, cmd, proc in jobs:
			_, err = proc.communicate()
			if proc.returncode != 0:
				errors.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{err}")
			else:
				os.replace(tmp, so)
		if errors:
			raise RuntimeError("\n".join(errors))
	finally:
		for _, tmp, _, proc in jobs:
			if proc.poll() is None:
				proc.kill()
				proc.wait()
			tmp.unlink(missing_ok=True)
	return libs


def _declare(lib: ctypes.CDLL, stem: str) -> None:
	p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
	sigs = {
		"dia_stencil": {
			# bands, offsets, n_d, x, out, mid, nv, n, vec, stream
			"dia_stencil_t": [p, p, i32, p, p, p, i64, i64, i32, p],
			# bands, offsets, n_d, v_cur, v_prev, state, w, partial, ticket, alpha_out, sums, nv, ld, lo, n, grid_x,
			# round, vec, stream
			"lanczos_dia_step": [p, p, i32, p, p, p, p, p, p, p, p, i64, i64, i64, i64, i64, i32, i32, p],
			# v_cur, w, state, alpha_src, partial, ticket, beta_out, sums, nv, ld, lo, n, tol, grid_x, vec, stream
			"lanczos_dia_residual": [p, p, p, p, p, p, p, p, i64, i64, i64, i64, ctypes.c_double, i64, i32, p],
			# bands, offsets, n_d, v_cur, v_prev, state, w, partial, ticket, sums, pend_sums, pend_alpha_out,
			# pend_beta_out, tol, nv, ld, lo, n, grid_x, vec, stream
			"lanczos_dia_step_finish": [p, p, i32, p, p, p, p, p, p, p, p, p, p, ctypes.c_double, i64, i64, i64, i64, i64, i32, p],
			# sums, state, alpha_out, beta_out, nv, tol, stream
			"lanczos_dia_advance": [p, p, p, p, i64, ctypes.c_double, p],
			# w, q, state, alpha_src, partial, ticket, alpha_out, beta_out, sums, nv, ld, lo, n, tol, grid_x, vec, stream
			"lanczos_dia_round_norm": [p, p, p, p, p, p, p, p, p, i64, i64, i64, i64, ctypes.c_double, i64, i32, p],
			# w, q, state, sums, alpha_out, beta_out, q_next, nv, ld, lo, n, tol, grid_x, vec, stream
			"lanczos_dia_round_write": [p, p, p, p, p, p, p, i64, i64, i64, i64, ctypes.c_double, i64, i32, p],
			# bands, offsets, n_d, V, out, n, k, vec, stream
			"dia_stencil": [p, p, i32, p, p, i64, i64, i32, p],
		},
		# blocks, indptr, indices, V, out, n_brow, bm, bn, m, k, n_out, vec, stream
		"bsr_spmm": {"bsr_spmm": [p, p, p, p, p, i64, i32, i32, i64, i64, i64, i32, p]},
	}.get(stem, {})
	for name, args in sigs.items():
		# The two DIA stencils, the BSR SpMM and the two step passes also have complex64 /
		# complex128 entry points; the stencils, the SpMM and pass A have bfloat16 ones, and the
		# round pair has only bfloat16 ones.
		dts = ("bf16",) if name.startswith("lanczos_dia_round") else ("f32", "f64")
		if name in ("dia_stencil_t", "dia_stencil", "bsr_spmm", "lanczos_dia_step"):
			dts += ("bf16",)
		if name in ("dia_stencil_t", "dia_stencil", "bsr_spmm", "lanczos_dia_step", "lanczos_dia_residual"):
			dts += ("c64", "c128")
		for dt in dts:
			if not hasattr(lib, f"{name}_{dt}"):  # a build of an earlier source (profile_port.py --against)
				continue
			fn = getattr(lib, f"{name}_{dt}")
			fn.argtypes = args
			fn.restype = i32
	if stem == "dia_stencil":
		lib.lanczos_step_blocks.argtypes = [i64, i64, i32, i32]  # nv, n, element bytes, complex
		lib.lanczos_step_blocks.restype = i64
		if hasattr(lib, "lanczos_round_blocks"):  # the bf16 round pair's grid; a build of an earlier source lacks it
			lib.lanczos_round_blocks.argtypes = [i64, i64]  # nv, n
			lib.lanczos_round_blocks.restype = i64
	if stem == "cgs_window":
		from .cgs import COMBOS

		for combo in COMBOS:
			# v, ld_v, q, ld_q, alpha, win, mask, top, ncv, proj_in, proj_out, sq_out, partial, ticket, nv, n, gx, vec,
			# stream
			fn = getattr(lib, f"cgs_window_{combo}")
			fn.argtypes = [p, i64, p, i64, p, p, ctypes.c_uint64, i64, i64, p, p, p, p, p, i64, i64, i64, i32, p]
			fn.restype = i32
			blocks = getattr(lib, f"cgs_window_blocks_{combo}")
			blocks.argtypes = [i64, i64]  # nv, n
			blocks.restype = i64
	if hasattr(lib, "bsr_spmm_l2_path"):
		lib.bsr_spmm_l2_path.argtypes = [i32, i32, i64, i64]  # bm, bn, m, k: whether complex128 takes its L2 path
		lib.bsr_spmm_l2_path.restype = i32
	lib.primate_cuda_error_string.argtypes = [i32]
	lib.primate_cuda_error_string.restype = ctypes.c_char_p


def load_library(stem: str = "dia_stencil") -> ctypes.CDLL:
	"""The shared library built from ``csrc/<stem>.cu``; the first call of the process builds them all."""
	if stem not in _LIBS:
		lib = ctypes.CDLL(str(build_library()[stem]))
		_declare(lib, stem)
		_LIBS[stem] = lib
	return _LIBS[stem]
