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
			# bands, offsets, n_d, x, out, nv, n, stream
			"dia_stencil_t": [p, p, i32, p, p, i64, i64, p],
			# bands, offsets, n_d, q_cur, q_prev, beta, v, partial, nv, n, stream
			"lanczos_dia_step": [p, p, i32, p, p, p, p, p, i64, i64, p],
			# bands, offsets, n_d, V, out, n, k, stream
			"dia_stencil": [p, p, i32, p, p, i64, i64, p],
		},
		# blocks, indptr, indices, V, out, n_brow, bm, bn, m, k, n_out, stream
		"bsr_spmm": {"bsr_spmm": [p, p, p, p, p, i64, i32, i32, i64, i64, i64, p]},
	}[stem]
	for name, args in sigs.items():
		for dt in ("f32", "f64"):
			fn = getattr(lib, f"{name}_{dt}")
			fn.argtypes = args
			fn.restype = i32
	if stem == "dia_stencil":
		lib.lanczos_dia_step_partials.argtypes = [i64]
		lib.lanczos_dia_step_partials.restype = i64
	lib.primate_cuda_error_string.argtypes = [i32]
	lib.primate_cuda_error_string.restype = ctypes.c_char_p


def load_library(stem: str = "dia_stencil") -> ctypes.CDLL:
	"""The shared library built from ``csrc/<stem>.cu``; the first call of the process builds them all."""
	if stem not in _LIBS:
		lib = ctypes.CDLL(str(build_library()[stem]))
		_declare(lib, stem)
		_LIBS[stem] = lib
	return _LIBS[stem]
