"""Native (C++) sparse-prep loader: host CSR → BSR tiles and DIA bands in one pass.

Counterpart of ``primate_tpu/native/__init__.py``, with its own copy of the C++
source (``sparse_prep.cpp``/``.h``): that package's ``__init__`` imports jax.
The source compiles at first use with the host's ``g++ -O3 -march=native`` into
``primate_tpu_torch/_build/`` (gitignored), under a name that carries a digest of
the source and flags and a fingerprint of the host's CPU: a library built with
``-march=native`` on one host can die of an illegal instruction on another that
shares the directory. Each compile writes a per-process temporary file and
renames it into place, so concurrent processes never load a half-written library.
It is bound by ctypes, and it is not one of the CUDA sources that
``ops._build`` compiles with nvcc.

:func:`available` is False when the library cannot be built or loaded, and the
converters then return None (their callers take scipy's route). A caller that
asks for this engine by name (``engine="native"``) gets the compiler's own error
from :func:`require`.
"""

import ctypes
import hashlib
import os
import platform
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

__all__ = ["available", "require", "library_path", "csr_analyze", "csr_to_bsr_arrays", "csr_to_dia_arrays"]

_HERE = Path(__file__).resolve().parent
_SRC = _HERE / "sparse_prep.cpp"
_BUILD_DIR = _HERE.parent / "_build"
GXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC")

_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")

# The loaded library, or the error that building or loading it raised (first use).
_STATE: dict = {}


def _host_tag() -> str:
	"""The machine name and a digest of the CPU's feature flags."""
	tag = platform.machine()
	try:
		with open("/proc/cpuinfo") as fh:
			for line in fh:
				if line.startswith(("flags", "Features")):
					tag += hashlib.sha1(line.encode()).hexdigest()[:8]
					break
	except OSError:
		pass
	return tag


def library_path() -> Path:
	"""Where the library for the current source, flags and host lives."""
	h = hashlib.sha1(" ".join(GXX_FLAGS).encode())
	for p in (_SRC, _HERE / "sparse_prep.h"):
		h.update(p.read_bytes())
	return _BUILD_DIR / f"libsparse_prep.{h.hexdigest()[:16]}.{_host_tag()}.so"


def _build() -> ctypes.CDLL:
	so = library_path()
	if not so.exists():
		_BUILD_DIR.mkdir(parents=True, exist_ok=True)
		tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
		cmd = ["g++", *GXX_FLAGS, str(_SRC), "-o", str(tmp)]
		try:
			proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
			if proc.returncode != 0:
				raise RuntimeError(f"g++ failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}")
			os.replace(tmp, so)
		finally:
			tmp.unlink(missing_ok=True)
	lib = ctypes.CDLL(str(so))
	lib.bsr_count.restype = ctypes.c_int64
	lib.bsr_count.argtypes = [ctypes.c_int64] * 4 + [_i64p, _i32p, _i64p]
	for suf, fp in (("f32", _f32p), ("f64", _f64p)):
		fn = getattr(lib, f"bsr_fill_{suf}")
		fn.restype = None
		fn.argtypes = [ctypes.c_int64] * 4 + [_i64p, _i32p, fp, _i64p, fp, _i32p, _i64p]
		fn = getattr(lib, f"dia_fill_{suf}")
		fn.restype = None
		fn.argtypes = [ctypes.c_int64] * 2 + [_i64p, _i32p, fp, ctypes.c_int64, _i64p, fp]
	lib.dia_count.restype = ctypes.c_int64
	lib.dia_count.argtypes = [ctypes.c_int64] * 2 + [_i64p, _i32p, _i64p]
	lib.csr_analyze.restype = None
	lib.csr_analyze.argtypes = [ctypes.c_int64] * 2 + [_i64p, _i32p] + [ctypes.c_int64] * 2 + [_i64p]
	return lib


def _lib() -> Optional[ctypes.CDLL]:
	if not _STATE:
		try:
			_STATE["lib"] = _build()
		except (OSError, AttributeError, RuntimeError, subprocess.SubprocessError) as e:
			_STATE["error"] = e
	return _STATE.get("lib")


def available() -> bool:
	"""True when the library built (or was already built) and loaded."""
	return _lib() is not None


def require() -> ctypes.CDLL:
	"""The library; raises what building or loading it raised (the compiler's message)."""
	lib = _lib()
	if lib is None:
		err = _STATE["error"]
		raise RuntimeError(f"the native sparse-prep library cannot be built: {err}") from err
	return lib


def _csr(A):
	import scipy.sparse as sps

	A = sps.csr_matrix(A)
	A.sum_duplicates()
	# Column ids cross the ABI as int32: the column count must fit.
	if A.shape[1] >= 2**31:
		raise OverflowError("native sparse-prep supports < 2^31 columns; use the scipy engine for wider matrices")
	return A


def _as_csr_parts(A) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray, Tuple[int, int]]]:
	"""Values, int32 column ids, int64 row pointers and shape; None for complex values (the
	C ABI is real only, so callers take scipy's route)."""
	A = _csr(A)
	data = np.ascontiguousarray(A.data)
	if data.dtype.kind == "c":
		return None
	if data.dtype not in (np.float32, np.float64):
		data = data.astype(np.float64)
	return data, np.ascontiguousarray(A.indices, np.int32), np.ascontiguousarray(A.indptr, np.int64), A.shape


def csr_analyze(A, bm: int = 8, bn: int = 8):
	"""One-pass structural statistics for the format choice of ``operators.prepare``:
	``{"n_diags", "bandwidth", "n_tiles", "max_row_nnz"}`` (distinct diagonals, max |i−j|,
	occupied ``bm × bn`` tiles, longest row), or None without the library. Reads only the
	index structure."""
	lib = _lib()
	if lib is None or A.shape[1] >= 2**31:
		return None
	A = _csr(A)
	out = np.zeros(4, np.int64)
	lib.csr_analyze(A.shape[0], A.shape[1], np.ascontiguousarray(A.indptr, np.int64),
		np.ascontiguousarray(A.indices, np.int32), bm, bn, out)
	return {"n_diags": int(out[0]), "bandwidth": int(out[1]), "n_tiles": int(out[2]), "max_row_nnz": int(out[3])}


def csr_to_bsr_arrays(A, bm: int, bn: int):
	"""CSR → ``(blocks (nnzb, bm, bn), colids, indptr_b)`` on the padded tile grid, block
	columns sorted within each block row, one zero coverage block per empty block row
	(as ``primate_tpu.native`` gives them); None without the library or for complex values."""
	lib = _lib()
	if lib is None or A.shape[1] >= 2**31:
		return None
	parts = _as_csr_parts(A)
	if parts is None:
		return None
	data, indices, indptr, (n, m) = parts
	n_brow = -(-n // bm)
	counts = np.zeros(n_brow, np.int64)
	nnzb = lib.bsr_count(n, m, bm, bn, indptr, indices, counts)
	blocks = np.zeros((nnzb, bm, bn), data.dtype)
	colids = np.zeros(nnzb, np.int32)
	indptr_b = np.zeros(n_brow + 1, np.int64)
	fill = lib.bsr_fill_f32 if data.dtype == np.float32 else lib.bsr_fill_f64
	fill(n, m, bm, bn, indptr, indices, data, counts, blocks, colids, indptr_b)
	return blocks, colids, indptr_b


def csr_to_dia_arrays(A):
	"""CSR → ``(offsets tuple, row-aligned bands (n_d, n))``, offsets ascending; None without
	the library or for complex values."""
	lib = _lib()
	if lib is None or A.shape[1] >= 2**31:
		return None
	parts = _as_csr_parts(A)
	if parts is None:
		return None
	data, indices, indptr, (n, m) = parts
	offsets_buf = np.zeros(n + m - 1, np.int64)
	n_d = lib.dia_count(n, m, indptr, indices, offsets_buf)
	offsets = np.ascontiguousarray(offsets_buf[:n_d])
	bands = np.zeros((n_d, n), data.dtype)
	fill = lib.dia_fill_f32 if data.dtype == np.float32 else lib.dia_fill_f64
	fill(n, m, indptr, indices, data, n_d, offsets, bands)
	return tuple(int(o) for o in offsets), bands
