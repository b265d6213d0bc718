"""Build and load the hand-written CUDA kernels of ``csrc/`` (plain C interface, ctypes).

Counterpart of the build pattern in ``primate_tpu/native/__init__.py``: the sources
compile at first use, never at import, into a cached shared library whose file
name carries a digest of the sources and flags, so an edited source rebuilds.
The compile writes a per-process temp file and renames it atomically, so
concurrent processes (xdist workers, several launches) never load a half-written
library. Unlike the JAX package's host helper there is no fallback: a build or
load failure raises.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

__all__ = ["NVCC_FLAGS", "build_library", "load_library", "nvcc_path"]

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC")

_LIB: Optional[ctypes.CDLL] = None


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


def _digest() -> str:
	h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
	for p in _sources() + sorted(_CSRC.glob("*.cuh")):
		h.update(p.name.encode())
		h.update(p.read_bytes())
	return h.hexdigest()[:16]


def build_library() -> Path:
	"""Compile ``csrc/*.cu`` for sm_90a unless the library for these sources exists; return its path."""
	so = _BUILD_DIR / f"libprimate_kernels.{_digest()}.so"
	if so.exists():
		return so
	_BUILD_DIR.mkdir(parents=True, exist_ok=True)
	tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
	cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), *(str(s) for s in _sources())]
	try:
		r = subprocess.run(cmd, capture_output=True, text=True)
		if r.returncode != 0:
			raise RuntimeError(f"nvcc failed ({r.returncode}): {' '.join(cmd)}\n{r.stderr}")
		os.replace(tmp, so)
	finally:
		tmp.unlink(missing_ok=True)
	return so


def _declare(lib: ctypes.CDLL) -> None:
	p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
	for dt in ("f32", "f64"):
		fn = getattr(lib, f"dia_stencil_t_{dt}")
		fn.argtypes = [p, p, i32, p, p, i64, i64, p]  # bands, offsets, n_d, x, out, nv, n, stream
		fn.restype = i32
		fn = getattr(lib, f"lanczos_dia_step_{dt}")
		fn.argtypes = [p, p, i32, p, p, p, p, p, i64, i64, p]  # bands, offsets, n_d, q_cur, q_prev, beta, v, partial, nv, n, stream
		fn.restype = i32
	lib.lanczos_dia_step_partials.argtypes = [i64]
	lib.lanczos_dia_step_partials.restype = i64
	lib.primate_cuda_error_string.argtypes = [i32]
	lib.primate_cuda_error_string.restype = ctypes.c_char_p


def load_library() -> ctypes.CDLL:
	"""The kernels' shared library, built on the first call of the process."""
	global _LIB
	if _LIB is None:
		lib = ctypes.CDLL(str(build_library()))
		_declare(lib)
		_LIB = lib
	return _LIB
