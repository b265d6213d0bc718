"""``primate_tpu_torch.parallel`` on the CPU under gloo: the counterparts of ``tests/test_parallel.py``,
the two sharded property cases of ``tests/test_property.py`` and the sweep's row-sharded carry.

A pool of 4 gloo ranks starts once for the module, as subprocesses of a worker script written to
``tmp_path`` (the pattern of ``tests/test_multiprocess.py``); each test sends a named case to every
rank and reads back each rank's arrays. The ranks never import jax. Meshes are ``(4, 1)``, ``(2, 2)``
and sub-meshes of 1 and 2 ranks (JAX's tests use 8 virtual devices; 8 processes would cost too much
CPU beside the suite's other workers). Each case holds the sharded result to scipy and to the
unsharded port in float64 at 1e-12 (estimates on the same seed; a sweep whose sums are taken rank by
rank at 1e-12 of the largest value); where a kernel-bearing apply is involved, also to the JAX
package's own sharded operator, computed here in the parent on the conftest's 8-device mesh. Every
rank must return the same estimate bit for bit (``tests/test_multiprocess.py``'s check).

``test_scaling_harness_smoke`` drives JAX's ``benchmarks/scaling.py``; its counterpart waits for the
port's benchmark (ROADMAP A.3).
"""

import json
import os
import select
import socket
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sps
from hypothesis import given, settings, strategies as st

import primate_tpu as pt
from primate_tpu.operators.sparse import DIAOperator as JaxDIA
from primate_tpu.parallel import make_mesh as jax_mesh, shard_operator as jax_shard

REPO = str(Path(__file__).resolve().parent.parent)
TIMEOUT = 120.0

_WORKER = r'''
import json, sys, traceback, warnings
from datetime import timedelta

rank, world, port, repo = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
sys.path.insert(0, repo)
import numpy as np
import scipy.sparse as sps
import torch
import torch.distributed as dist

torch.set_num_threads(1)
import primate_tpu_torch as ptt
from primate_tpu_torch.parallel import (
	ShardedBSROperator, ShardedCSROperator, ShardedDenseOperator, ShardedDIAOperator, auto_shard_operator,
	initialize_distributed, make_mesh, mesh_devices, shard_operator,
)
from primate_tpu_torch.parallel import _comm

initialize_distributed("gloo", init_method=f"tcp://localhost:{port}", world_size=world, rank=rank, timeout=timedelta(seconds=90))
CPU = dict(device="cpu")
F64 = torch.float64
_MESHES = {}


def mesh(shape=(4, 1), ranks=None):
	"""The mesh (made once, by every rank in the same order), or None on a rank outside it."""
	key = (tuple(shape), None if ranks is None else tuple(ranks))
	if key not in _MESHES:
		_MESHES[key] = make_mesh(shape, devices=ranks, device_type="cpu")
	m = _MESHES[key]
	return m if m.get_coordinate() is not None else None


def sub(ws):
	"""A ``(ws, 1)`` mesh over the first ``ws`` ranks."""
	return mesh((ws, 1), list(range(ws)))


def lap(n):
	main = 2.0 * np.ones(n) + 1.0
	off = -1.0 * np.ones(n - 1)
	return sps.diags([off, main, off], [-1, 0, 1]).tocsr()


def rsym(n, seed):
	A = sps.random(n, n, density=0.06, random_state=np.random.default_rng(seed), format="csr")
	return (A + A.T).tocsr()


def t(x):
	return torch.as_tensor(np.asarray(x), dtype=F64)


def a(x):
	x = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x
	return np.asarray(x)


def dia(A):
	return ptt.DIAOperator.from_scipy(sps.csr_matrix(A), dtype=F64, **CPU)


CASES = {}


def case(fn):
	CASES[fn.__name__] = fn
	return fn


def raised(fn):
	try:
		fn()
	except (ValueError, TypeError) as e:
		return {"raised": type(e).__name__ + ": " + str(e)}
	return {"raised": ""}


@case
def mesh_shapes():
	m, m22, m2 = mesh(), mesh((2, 2)), sub(2)
	out = dict(op=m.size(0), probe=m.size(1), op22=m22.size(0), probe22=m22.size(1), ndev=len(mesh_devices(device_type="cpu")),
		coord=np.asarray(m22.get_coordinate()))
	out["in2"] = m2 is not None
	return out


@case
def dense_matmat(n, seed):
	A = np.random.default_rng(seed).normal(size=(n, n))
	A = (A + A.T) / 2
	op = shard_operator(t(A), mesh(), **CPU)
	V = np.random.default_rng(1).normal(size=(n, 5))
	return dict(got=a(op.matmat(t(V))), isdense=isinstance(op, ShardedDenseOperator))


@case
def bsr_apply(kind, n, comm, seed=2, k=7, ws=4, shape=None, probe=None, bs=8, zero_at=None, mseed=3):
	m = mesh(shape) if shape else sub(ws)
	if m is None:
		return None
	A = lap(n) if kind == "lap" else rsym(n, mseed)
	if zero_at is not None:
		Z = sps.csr_matrix((np.array([1.0]), (np.array([0]), np.array([zero_at]))), shape=A.shape)
		A = (A + Z).tocsr()
		A.data[np.flatnonzero(A.indices[: A.indptr[1]] == zero_at)] = 0.0
	op = shard_operator(A, m, comm=comm, blocksize=(bs, bs), probe_axis=probe, **CPU)
	V = np.random.default_rng(seed).normal(size=(n, k))
	out = dict(got=a(op.matmat(t(V))), got_t=a(op.matmat_t(t(V.T.copy()))), dense=a(op.todense()), comm=op.comm,
		halo=op.halo, bpd=op.bpd, colids=a(op.colids), isbsr=isinstance(op, ShardedBSROperator))
	return out


@case
def bsr_halo_invalid():
	return raised(lambda: shard_operator(rsym(128, 5), mesh(), comm="halo", blocksize=(8, 8), **CPU))


@case
def hutch_same_seed(kind, n=96, count=256, seed=11, ws=4):
	m = sub(ws)
	if m is None:
		return None
	A = lap(n)
	op = shard_operator(A, m, comm="halo", blocksize=(8, 8), **CPU) if kind == "bsr" else shard_operator(dia(A), m)
	est = ptt.hutch(op, seed=seed, converge="count", count=count)
	ref = ptt.hutch(t(A.toarray()), seed=seed, converge="count", count=count)
	return dict(est=est, ref=ref)


@case
def rayleigh_ritz(n=96):
	op = shard_operator(lap(n), mesh(), comm="halo", blocksize=(8, 8), **CPU)
	return dict(rw=a(ptt.rayleigh_ritz(op, deg=n, orth=n, seed=7)))


@case
def dia_apply(n, offsets=None, probe=None, shape=None, seed=3, k=5):
	m = mesh(shape) if shape else mesh()
	rng = np.random.default_rng(seed)
	if offsets is None:
		A = lap(n)
	else:
		A = sps.diags([rng.normal(size=n - abs(o)) for o in offsets], offsets).tocsr()
	op = shard_operator(dia(A), m) if probe is None else ShardedDIAOperator.from_dia(A.todia(), m, probe_axis=probe, dtype=F64, **CPU)
	V = rng.normal(size=(n, k))
	return dict(got=a(op.matmat(t(V))), got_t=a(op.matmat_t(t(V.T.copy()))), dense=a(op.todense()),
		isdia=isinstance(op, ShardedDIAOperator))


@case
def dia_halo_too_wide():
	n = 64
	A = sps.diags([np.ones(n - 20), np.ones(n)], [-20, 0])
	return raised(lambda: ShardedDIAOperator.from_dia(A.todia(), mesh(), **CPU))


@case
def slq(kind, n, deg, orth, count, batch, seed, fun="log", ws=4, shape=None, probe=None, ts=None):
	m = mesh(shape) if shape else sub(ws)
	if m is None:
		return None
	A = rsym(n, 17) if kind == "csr_spd" else lap(n)
	if kind == "csr_spd":
		A = A.tolil()
		A.setdiag(np.abs(A).sum(axis=1).A1 + 1.0)
		A = A.tocsr()
	make = {
		"bsr": lambda: shard_operator(A, m, comm="halo", blocksize=(8, 8), probe_axis=probe, **CPU),
		"dia": lambda: shard_operator(dia(A), m, probe_axis=probe),
		"csr": lambda: ShardedCSROperator.from_csr(A, m, probe_axis=probe, **CPU),
		"csr_spd": lambda: ShardedCSROperator.from_csr(A, m, probe_axis=probe, **CPU),
		"dense": lambda: shard_operator(t(A.toarray()), m, **CPU),
	}
	op = make[kind]()
	f = fun if ts is None else ptt.stacked("exp", -np.asarray(ts))
	M = ptt.MatrixFunction(op, fun=f, deg=deg, orth=orth)
	M0 = ptt.MatrixFunction(ptt.CSROperator.from_scipy(A, dtype=F64, **CPU), fun=f, deg=deg, orth=orth)
	est = ptt.hutch(M, seed=seed, converge="count", count=count, batch=batch)
	ref = ptt.hutch(M0, seed=seed, converge="count", count=count, batch=batch)
	return dict(est=np.asarray(est), ref=np.asarray(ref), dense=A.toarray())


@case
def all_estimators(n=96):
	A = lap(n)
	op = shard_operator(dia(A), mesh())
	b = np.random.default_rng(5).normal(size=n)
	return dict(
		hutchpp=ptt.hutchpp(op, m=24, seed=1), xtrace=ptt.xtrace(op, batch=24, seed=2),
		diag=a(ptt.diag(op, seed=3, converge="count", count=512)), xdiag=a(ptt.xdiag(op, m=64, seed=4)),
		x=a(ptt.solve(op, t(b), rtol=1e-10)), b=b, A=A.toarray(),
	)


@case
def kpm(n=256):
	A = lap(n)
	loc = dia(A)
	op = shard_operator(loc, mesh())
	M_l = ptt.ChebyshevFunction(loc, fun="exp", deg=48, interval=(0.0, 6.5))
	M_s = ptt.ChebyshevFunction(op, fun="exp", deg=48, interval=(0.0, 6.5))
	V = np.random.default_rng(9).normal(size=(n, 4))
	return dict(
		ms=a(M_s.matmat(t(V))), ml=a(M_l.matmat(t(V))),
		est_s=ptt.hutch(M_s, batch=32, converge="count", count=64, seed=3),
		est_l=ptt.hutch(M_l, batch=32, converge="count", count=64, seed=3),
	)


@case
def eigsh(n=256):
	op = shard_operator(lap(n).todia(), mesh(), probe_axis=None, **CPU)
	return dict(w=a(ptt.eigsh(op, k=3, which="LA", seed=0, return_eigenvectors=False, **CPU)))


@case
def xnystrace(n=256):
	op = shard_operator(lap(n).todia(), mesh(), probe_axis=None, **CPU)
	return dict(est=ptt.xnystrace(op, m=128, seed=1))


@case
def deflated_trace(n=256):
	op = shard_operator(lap(n).todia(), mesh(), probe_axis=None, **CPU)
	return dict(est=ptt.recipes.deflated_trace(op, k=4, seed=2, converge="count", count=256))


@case
def auto_shuffled(n=256, seed=3, k=6):
	A = lap(n)
	p = np.random.default_rng(seed).permutation(n)
	Ash = A[p][:, p].tocsr()
	op, info = auto_shard_operator(Ash, mesh(), probe_axis="probe", dense_n=64, **CPU)
	V = np.random.default_rng(4).normal(size=(n, k))
	got = info.unpermute(a(op.matmat(t(info.permute(V)))))
	return dict(got=got, want=Ash @ V, format=info.format, perm=info.perm is not None, isdia=isinstance(op, ShardedDIAOperator))


@case
def auto_trace(n=512):
	A = lap(n)
	p = np.random.default_rng(5).permutation(n)
	Ash = A[p][:, p].tocsr()
	op, _ = auto_shard_operator(Ash, mesh(), probe_axis="probe", dense_n=64, **CPU)
	ref = ptt.hutch(ptt.operators.auto_operator(Ash, dense_n=64, **CPU)[0], converge="count", count=64, seed=7)
	return dict(est=ptt.hutch(op, converge="count", count=64, seed=7), ref=ref)


@case
def auto_scattered(n=256):
	A = rsym(n, 9)
	op, info = auto_shard_operator(A, mesh(), dense_density=0.5, dense_n=64, **CPU)
	V = np.random.default_rng(10).normal(size=(n, 4))
	return dict(got=a(op.matmat(t(V))), format=info.format, perm=info.perm is not None,
		iscsr=isinstance(op, ShardedCSROperator))


@case
def csr_apply(kind, n, comm="auto", seed=12, k=5, ws=4, bw=None):
	m = sub(ws)
	if m is None:
		return None
	if kind == "rsym":
		A = rsym(n, 11 if n == 300 else 73)
	elif kind == "skew":
		S = sps.random(n, n, density=0.004, random_state=15).tolil()
		S[0, :250] = 1.0
		A = (S + S.T).tocsr()
	elif kind == "band7":
		A = sps.diags([np.ones(n - 7), 3.0 * np.ones(n), np.ones(n - 7)], [-7, 0, 7]).tocsr()
	else:
		A = lap(n)
	op = ShardedCSROperator.from_csr(A, m, comm=comm, **CPU)
	V = np.random.default_rng(seed).normal(size=(n, k))
	return dict(got=a(op.matmat(t(V))), got_t=a(op.matmat_t(t(V.T.copy()))), dense=a(op.todense()), comm=op.comm,
		halo=op.halo, local_nnz=op.local.nnz)


@case
def csr_halo_scattered_raises():
	return raised(lambda: ShardedCSROperator.from_csr(rsym(300, 14), mesh(), comm="halo", **CPU))


@case
def blocksize_optin_warns():
	op = ptt.CSROperator.from_scipy(rsym(256, 23), **CPU)
	with warnings.catch_warnings(record=True) as w:
		warnings.simplefilter("always")
		sharded = shard_operator(op, mesh(), blocksize=(8, 8))
	return dict(warned=any("not block-structured" in str(x.message) for x in w), isbsr=isinstance(sharded, ShardedBSROperator))


@case
def eigensolvers(n=512):
	op, _ = auto_shard_operator(lap(n), mesh(), **CPU)
	w = ptt.eigsh(op, k=3, which="SA", seed=1, method="trlan", return_eigenvectors=False, **CPU)
	wf, _ = ptt.filtered_eigsh(op, (2.5, 2.7), seed=2, **CPU)
	return dict(w=a(w), wf=a(wf))


@case
def csr_kwarg_compat():
	A = rsym(128, 31)
	op = shard_operator(ptt.CSROperator.from_scipy(A, **CPU), mesh(), use_pallas=True)
	V = np.random.default_rng(32).normal(size=(128, 3))
	rect = sps.random(64, 48, density=0.05, random_state=33, format="csr")
	out = raised(lambda: ShardedCSROperator.from_csr(rect, mesh(), comm="halo", **CPU))
	out.update(got=a(op.matmat(t(V))), iscsr=isinstance(op, ShardedCSROperator))
	return out


@case
def dense_uneven():
	rng = np.random.default_rng(41)
	A = rng.normal(size=(37, 37))
	A = (A + A.T) / 2
	op = shard_operator(t(A), mesh(), dtype=torch.float32, **CPU)
	V = rng.normal(size=(37, 3))
	V32 = torch.tensor(V, dtype=torch.float32)
	return dict(dtype=str(op.dtype), shape=np.asarray(op.shape), got=a(op.matmat(V32)), got_t=a(op.matmat_t(V32.T.contiguous())),
		rv=a(op.rmatvec(V32[:, 0])))


@case
def bsr_empty_block_rows(n=128):
	L = lap(n).tolil()
	L[40:48, :] = 0.0
	L[:, 40:48] = 0.0
	L = L.tocsr()
	op = shard_operator(L, mesh(), comm="auto", blocksize=(8, 8), **CPU)
	V = np.random.default_rng(43).normal(size=(n, 3))
	return dict(comm=op.comm, got=a(op.matmat(t(V))))


@case
def csr_slq_probe_major(n=256):
	L = lap(n)
	opc = ShardedCSROperator.from_csr(L, mesh(), **CPU)
	M = ptt.MatrixFunction(opc, fun="log", deg=16, orth=4)
	return dict(est=ptt.hutch(M, converge="count", count=64, seed=81))


@case
def random_band_csr(n, bw, seed, ndev, comm):
	m = sub(ndev)
	if m is None:
		return None
	rng = np.random.default_rng(seed)
	rows, cols, vals = [], [], []
	for i in range(n):
		lo, hi = max(0, i - bw), min(n, i + bw + 1)
		take = rng.integers(lo, hi, size=min(3, hi - lo), endpoint=False) if hi > lo else []
		for j in np.unique(take):
			rows.append(i)
			cols.append(int(j))
			vals.append(float(rng.normal()))
	A = (sps.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr() + sps.eye(n)).tocsr()
	op = ShardedCSROperator.from_csr(A, m, comm=comm, **CPU)
	V = rng.normal(size=(n, 3))
	return dict(got=a(op.matmat(t(V))), got_t=a(op.matmat_t(t(V.T.copy()))), want=A @ V, comm=op.comm)


@case
def random_tridiag_bsr(nb, bs, seed, ndev):
	m = sub(ndev)
	if m is None:
		return None
	rng = np.random.default_rng(seed)
	n = nb * bs
	diags, offs = [rng.normal(size=n).astype(np.float32)], [0]
	if n > bs:
		diags += [rng.normal(size=n - 1).astype(np.float32), rng.normal(size=n - 1).astype(np.float32)]
		offs += [1, -1]
	A = sps.diags(diags, offs).tocsr().astype(np.float32)
	op = shard_operator(A, m, comm="auto", blocksize=(bs, bs), **CPU)
	V = rng.normal(size=(n, 2)).astype(np.float32)
	return dict(got=a(op.matmat(torch.tensor(V))), want=A @ V, comm=op.comm)


@case
def sweep(kind, n, deg, orth, nv, shape, ranks=None, probe=None, selective=False, return_basis=False, two_pass=None, path=None):
	"""The sweep on the local face against the unsharded port on the same block; α, β, the basis,
	f(A)V one and two pass, and quad on the same probes."""
	m = mesh(shape, ranks)
	if m is None:
		return None
	A = lap(n)
	op = {
		"dia": lambda: shard_operator(dia(A), m, probe_axis=probe),
		"bsr": lambda: shard_operator(A, m, comm="halo", blocksize=(4, 4), probe_axis=probe, **CPU),
		"bsr_ag": lambda: shard_operator(A, m, comm="allgather", blocksize=(4, 4), probe_axis=probe, **CPU),
		"csr": lambda: ShardedCSROperator.from_csr(A, m, probe_axis=probe, **CPU),
		"dense": lambda: shard_operator(t(A.toarray()), m, **CPU),
	}[kind]()
	V = np.load(path)["V"] if path else np.random.default_rng(0).normal(size=(n, nv))
	out = {}
	for name, o in (("s", op), ("u", dia(A))):
		(al, be), Q = ptt.lanczos(o, v0=t(V), deg=deg, orth=orth, selective=selective, return_basis=True, **CPU)
		out[name + "a"], out[name + "b"], out[name + "Q"] = a(al), a(be), a(Q)
		M = ptt.MatrixFunction(o, "log", deg=deg, orth=orth, two_pass=two_pass if two_pass is not None else "auto")
		out[name + "f"] = a(M.matmat(t(V)))
		out[name + "q"] = a(M.quad(t(V)))
	return out


def band(n, seed=12):
	"""A symmetric positive definite band of ±1, ±7 and ±40 (diagonally dominant)."""
	rng = np.random.default_rng(seed)
	offs = (1, 7, 40)
	A = sps.diags([rng.uniform(-0.3, 0.3, size=n - o) for o in offs], offs)
	return (A + A.T + 3.0 * sps.eye(n)).tocsr()


from primate_tpu_torch.operators import sparse as _sparse
from primate_tpu_torch.parallel import sharded as _sharded

STEP_CALLS = {}


def _count(mod, name):
	"""Count the calls of the step wrapper ``name`` that ``mod``'s operators make."""
	real = getattr(mod, name)

	def counted(*args, **kwargs):
		STEP_CALLS[name] = STEP_CALLS.get(name, 0) + 1
		return real(*args, **kwargs)

	setattr(mod, name, counted)


for _mod in (_sparse, _sharded):
	for _name in ("lanczos_dia_sweep_step", "lanczos_dia_step", "lanczos_dia_round_step"):
		_count(_mod, _name)


@case
def band_sweep(n, deg, orth, nv, shape, ranks=None, probe=None):
	"""The sweep of a wide-band sharded DIA operator against the unsharded port on the same block:
	α, β and the basis of one ``lanczos`` call (with the step functions it went through), f(A)V and quad."""
	m = mesh(shape, ranks)
	if m is None:
		return None
	A = band(n)
	V = np.random.default_rng(0).normal(size=(n, nv))
	out = {}
	for name, o in (("s", shard_operator(dia(A), m, probe_axis=probe)), ("u", dia(A))):
		STEP_CALLS.clear()
		(al, be), Q = ptt.lanczos(o, v0=t(V), deg=deg, orth=orth, return_basis=True, **CPU)
		out[name + "calls"] = np.array([STEP_CALLS.get("lanczos_dia_sweep_step", 0), STEP_CALLS.get("lanczos_dia_step", 0)])
		out[name + "a"], out[name + "b"], out[name + "Q"] = a(al), a(be), a(Q)
		M = ptt.MatrixFunction(o, "log", deg=deg, orth=orth)
		out[name + "f"] = a(M.matmat(t(V)))
		out[name + "q"] = a(M.quad(t(V)))
	return out


@case
def bf16_round_sweep(n, deg, nv, shape, ranks=None, probe=None):
	"""The bf16 sweep (orth 0) of the sharded and the unsharded DIA operator of tridiag(−1, 3, −1) on
	the same Rademacher block: α, β and the calls of the step wrappers each made."""
	m = mesh(shape, ranks)
	if m is None:
		return None
	A = lap(n)
	V = torch.from_numpy(np.random.default_rng(0).choice([-1.0, 1.0], size=(n, nv))).to(torch.bfloat16)
	out = {}
	for name, o in (("s", shard_operator(ptt.DIAOperator.from_scipy(A, dtype=torch.bfloat16, **CPU), m, probe_axis=probe)),
			("u", ptt.DIAOperator.from_scipy(A, dtype=torch.bfloat16, **CPU))):
		STEP_CALLS.clear()
		res = ptt.lanczos_block_op(o, V, deg=deg, ncv=2, orth=0, return_basis=False)
		out[name + "calls"] = np.array([STEP_CALLS.get(k, 0) for k in ("lanczos_dia_round_step", "lanczos_dia_step", "lanczos_dia_sweep_step")])
		out[name + "a"], out[name + "b"] = a(res.alphas), a(res.betas)
	return out


from primate_tpu_torch.ops import dia as _dia

FINISHES = {"standalone": 0}


def _counted_flush(self, state):
	"""The sweep's own finishes (``lanczos_sweep_flush`` with a step pending), counted."""
	FINISHES["standalone"] += bool(state.pending)
	return _REAL_FLUSH(self, state)


def _eager_sweep_step(self, v_cur, v_prev, state, alpha_out, beta_out, residual_tol, layout=None):
	"""The sharded step with its finish run at once (both passes, then the finish: the plain step with ``reduce``)."""
	self._exchange(v_cur)
	apply_t = lambda q: _dia.dia_stencil_t_ref(self.local.bands, self.local.offsets_t, q)  # noqa: E731
	return _dia.lanczos_sweep_step_ref(apply_t, v_cur, v_prev, state, alpha_out, beta_out, residual_tol, self._reduce, self._spec)


def _eager_round_step(self, q_cur, q_prev, state, alpha_out, beta_out, residual_tol, layout=None):
	"""The sharded bf16 step with the round pair's plain version in one piece (``lanczos_dia_round_ref``)."""
	self._exchange(q_cur)
	s = state.scal
	w, alpha = _dia.lanczos_dia_step_ref(self.local.bands, self.local.offsets_t, q_cur, q_prev, s[_dia.BETA], self._spec, self._reduce)
	sums = torch.stack([alpha, torch.empty_like(alpha)])
	return _dia.lanczos_dia_round_ref(w, q_cur, state, alpha_out, beta_out, residual_tol, self._spec, self._reduce, sums)


def _breakdown(n):
	"""tridiag(−1, 3, −1) with rows 0-2 cut off from the rest: a probe supported there breaks down at step 3."""
	A = lap(n).tolil()
	A[2, 3] = A[3, 2] = 0.0
	return A.tocsr()


@case
def deferred_finish(kind, n, deg, nv, ws):
	"""The float64 sweep (orth 0) of a sharded DIA operator on ``ws`` ranks as the port runs it (each step's finish
	deferred to the next step, ``lanczos_sharded_step_ref``) and with every step finished at once
	(``_eager_sweep_step``), on the same block: α, β, the basis (``kind`` "basis"), f(A)V (``y``: "fav"), the quad, the
	standalone finishes of the first, and the unsharded port's α and β. ``kind`` "breakdown": probe 0 breaks down at
	step 3."""
	m = sub(ws)
	if m is None:
		return None
	A = _breakdown(n) if kind == "breakdown" else lap(n)
	V = np.random.default_rng(7).normal(size=(n, nv))
	if kind == "breakdown":
		V[3:, 0] = 0.0
	op = shard_operator(dia(A), m)
	out = {}
	for name, step in (("d", None), ("e", _eager_sweep_step)):
		if step is not None:
			ShardedDIAOperator.lanczos_sweep_step = step
		ShardedDIAOperator.lanczos_sweep_flush = _counted_flush
		try:
			FINISHES["standalone"] = 0
			res = ptt.lanczos_block_op(op, t(V), deg=deg, ncv=2, orth=0, return_basis=kind == "basis")
			out[name + "finishes"] = FINISHES["standalone"]
			out[name + "a"], out[name + "b"] = a(res.alphas), a(res.betas)
			if kind == "basis":
				out[name + "Q"] = a(res.Q)
			if kind == "fav":
				FINISHES["standalone"] = 0
				out[name + "f"] = a(ptt.MatrixFunction(op, "log", deg=deg, orth=0, two_pass=False).matmat(t(V)))
				out[name + "ffinishes"] = FINISHES["standalone"]
			if deg > 1:  # MatrixFunction takes deg ≥ 2
				out[name + "q"] = a(ptt.MatrixFunction(op, "log", deg=deg, orth=0).quad(t(V)))
		finally:
			ShardedDIAOperator.lanczos_sweep_step, ShardedDIAOperator.lanczos_sweep_flush = _REAL_SWEEP_STEP, _REAL_FLUSH
	res = ptt.lanczos_block_op(dia(A), t(V), deg=deg, ncv=2, orth=0)
	out["ua"], out["ub"] = a(res.alphas), a(res.betas)
	return out


@case
def deferred_round_finish(n, deg, nv, ws):
	"""The bf16 sweep of a sharded DIA operator on ``ws`` ranks as the port runs it (the round pair split as its
	kernels split it, the step's finish in B2: ``lanczos_round_pair_ref``) and with the round pair's plain version
	in one piece (``lanczos_dia_round_ref``): α and β, and the standalone finishes (none)."""
	m = sub(ws)
	if m is None:
		return None
	V = torch.from_numpy(np.random.default_rng(1).choice([-1.0, 1.0], size=(n, nv))).to(torch.bfloat16)
	op = shard_operator(ptt.DIAOperator.from_scipy(lap(n), dtype=torch.bfloat16, **CPU), m)
	out = {}
	for name, step in (("d", None), ("e", _eager_round_step)):
		if step is not None:
			ShardedDIAOperator.lanczos_round_step = step
		ShardedDIAOperator.lanczos_sweep_flush = _counted_flush
		try:
			FINISHES["standalone"] = 0
			res = ptt.lanczos_block_op(op, V, deg=deg, ncv=2, orth=0, return_basis=False)
			out[name + "a"], out[name + "b"], out[name + "finishes"] = a(res.alphas), a(res.betas), FINISHES["standalone"]
		finally:
			ShardedDIAOperator.lanczos_round_step, ShardedDIAOperator.lanczos_sweep_flush = _REAL_ROUND_STEP, _REAL_FLUSH
	return out


_REAL_SWEEP_STEP, _REAL_ROUND_STEP = ShardedDIAOperator.lanczos_sweep_step, ShardedDIAOperator.lanczos_round_step
_REAL_FLUSH = ShardedDIAOperator.lanczos_sweep_flush


@case
def comm_primitives(ws=4):
	"""halo_exchange fills the inner halos from the ring neighbours and leaves the ends zero;
	all_gather_rows' backward sums the ranks' cotangents and keeps the rank's piece."""
	m = sub(ws)
	if m is None:
		return None
	g = m.get_group("op")
	r, h, nl = dist.get_rank(g), 2, 5
	X = torch.zeros((3, h + nl + h), dtype=F64)
	X[:, h : h + nl] = torch.arange(nl, dtype=F64) + 10 * r
	_comm.halo_exchange(X, h, g, dim=1)
	x = torch.full((2, 3), float(r + 1), dtype=F64, requires_grad=True)
	y = _comm.all_gather_rows(x, 2 * ws - 1, g, 0)
	(y * (r + 1)).sum().backward()
	return dict(X=a(X), y=a(y), grad=a(x.grad))


for line in sys.stdin:
	msg = json.loads(line)
	try:
		out = CASES[msg["case"]](**msg["kwargs"])
		if out is not None:
			np.savez(f"{msg['out']}.{rank}.npz", **{k: np.asarray(v) for k, v in out.items()})
		print(json.dumps({"ok": True, "none": out is None}), flush=True)
	except Exception:
		print(json.dumps({"ok": False, "error": traceback.format_exc()}), flush=True)
'''


def _free_port() -> int:
	with socket.socket() as s:
		s.bind(("localhost", 0))
		return s.getsockname()[1]


class _Pool:
	"""Four gloo ranks reading cases from their standard input."""

	WORLD = 4

	def __init__(self, tmp: Path):
		worker = tmp / "parallel_worker.py"
		worker.write_text(_WORKER)
		self.tmp, self.count = tmp, 0
		port = _free_port()
		env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
		self.procs = [
			subprocess.Popen(
				[sys.executable, str(worker), str(r), str(self.WORLD), str(port), REPO],
				stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True, env=env,
			)
			for r in range(self.WORLD)
		]

	def run(self, case: str, **kwargs) -> list:
		"""Each rank's arrays for ``case`` (None on a rank outside the case's mesh)."""
		self.count += 1
		out = str(self.tmp / f"case{self.count}")
		msg = json.dumps({"case": case, "kwargs": kwargs, "out": out}) + "\n"
		for p in self.procs:
			p.stdin.write(msg)
			p.stdin.flush()
		replies = []
		deadline = time.monotonic() + TIMEOUT
		for p in self.procs:
			ready, _, _ = select.select([p.stdout], [], [], max(0.0, deadline - time.monotonic()))
			if not ready:
				self.close()
				raise TimeoutError(f"case {case} timed out")
			replies.append(json.loads(p.stdout.readline() or '{"ok": false, "error": "rank exited"}'))
		errors = [r["error"] for r in replies if not r["ok"]]
		if errors:
			self.close()
			raise AssertionError(f"case {case} failed:\n{errors[0]}")
		results = []
		for rank, r in enumerate(replies):
			if r["none"]:
				results.append(None)
			else:
				with np.load(f"{out}.{rank}.npz", allow_pickle=False) as z:
					results.append({k: z[k] for k in z.files})
		return results

	def alive(self) -> bool:
		return all(p.poll() is None for p in self.procs)

	def close(self) -> None:
		for p in self.procs:
			if p.poll() is None:
				p.kill()
			p.wait(timeout=10)


_POOL = {}


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
	yield _PoolHandle(tmp_path_factory)
	if "pool" in _POOL:
		_POOL.pop("pool").close()


class _PoolHandle:
	"""Starts the pool at first use, and again after a case that failed took it down."""

	def __init__(self, factory):
		self.factory = factory

	def run(self, case: str, **kwargs) -> list:
		p = _POOL.get("pool")
		if p is None or not p.alive():
			_POOL["pool"] = p = _Pool(self.factory.mktemp("ranks"))
		return p.run(case, **kwargs)


def _one(results: list, skip=("colids", "local_nnz")) -> dict:
	"""The result of rank 0, after checking that every rank in the mesh returned the same arrays
	(but for those of ``skip``, which are the rank's own)."""
	got = [{k: v for k, v in r.items() if k not in skip} for r in results if r is not None]
	for r in got[1:]:
		assert r.keys() == got[0].keys()
		for k in r:
			assert np.array_equal(r[k], got[0][k]), f"ranks disagree on {k}"
	return got[0]


def _laplacian(n: int) -> sps.csr_matrix:
	main = 2.0 * np.ones(n) + 1.0
	off = -1.0 * np.ones(n - 1)
	return sps.diags([off, main, off], [-1, 0, 1]).tocsr()


def _random_sym_sparse(n: int, seed: int) -> sps.csr_matrix:
	A = sps.random(n, n, density=0.06, random_state=np.random.default_rng(seed), format="csr")
	return (A + A.T).tocsr()


@pytest.fixture(scope="module")
def mesh8():
	assert jax.device_count() >= 8, "conftest must force 8 virtual CPU devices"
	return jax_mesh((8, 1), ("op", "probe"))


def _close(got, want, tol=1e-12):
	got, want = np.asarray(got), np.asarray(want)
	scale = max(1.0, float(np.max(np.abs(want))) if want.size else 1.0)
	assert got.shape == want.shape, (got.shape, want.shape)
	assert np.max(np.abs(got - want), initial=0.0) <= tol * scale, np.max(np.abs(got - want))


# -- counterparts of tests/test_parallel.py, in its order ---------------------------------------


def test_mesh_shapes(pool):
	r = pool.run("mesh_shapes")
	assert [x["in2"] for x in r] == [True, True, False, False]
	r0 = _one(r, skip=("in2", "coord"))
	assert r0["op"] == 4 and r0["probe"] == 1 and r0["op22"] == 2 and r0["probe22"] == 2 and r0["ndev"] == 4
	assert [tuple(x["coord"]) for x in r] == [(0, 0), (0, 1), (1, 0), (1, 1)]


def test_sharded_dense_matmat(pool):
	r = _one(pool.run("dense_matmat", n=96, seed=0))
	A = np.random.default_rng(0).normal(size=(96, 96))
	A = (A + A.T) / 2
	assert r["isdense"]
	_close(r["got"], A @ np.random.default_rng(1).normal(size=(96, 5)))


@pytest.mark.parametrize("comm", ["allgather", "halo"])
def test_sharded_bsr_banded(pool, mesh8, comm):
	n = 128
	A = _laplacian(n)
	r = _one(pool.run("bsr_apply", kind="lap", n=n, comm=comm))
	V = np.random.default_rng(2).normal(size=(n, 7))
	assert r["isbsr"] and r["comm"] == comm
	_close(r["got"], A @ V)
	_close(r["dense"], A.toarray())
	jop = jax_shard(A, mesh8, comm=comm, blocksize=(8, 8))
	_close(r["got"], np.asarray(jop.matmat(jnp.asarray(V))))


def test_sharded_bsr_general_pattern_falls_back(pool, mesh8):
	A = _random_sym_sparse(128, seed=3)
	r = _one(pool.run("bsr_apply", kind="rsym", n=128, comm="auto", seed=4, k=4))
	assert r["comm"] == "allgather"
	V = np.random.default_rng(4).normal(size=(128, 4))
	_close(r["got"], A @ V)
	_close(r["got"], np.asarray(jax_shard(A, mesh8, comm="auto", blocksize=(8, 8)).matmat(jnp.asarray(V))))


def test_halo_requested_but_invalid_raises(pool):
	r = _one(pool.run("bsr_halo_invalid"))
	assert str(r["raised"]).startswith("ValueError") and "halo" in str(r["raised"])


@pytest.mark.parametrize("ws", [1, 2, 4])
def test_uneven_rows_padding(pool, mesh8, ws):
	# 9 block rows: at 4 ranks, 3, 3, 3 and an empty last rank.
	n = 72
	A = _laplacian(n)
	r = _one(pool.run("bsr_apply", kind="lap", n=n, comm="halo", seed=6, k=3, ws=ws))
	V = np.random.default_rng(6).normal(size=(n, 3))
	_close(r["got"], A @ V)
	_close(r["got_t"], (A @ V).T)
	_close(r["got"], np.asarray(jax_shard(A, mesh8, comm="halo", blocksize=(8, 8)).matmat(jnp.asarray(V))))


@pytest.mark.parametrize("ws", [1, 2, 4])
def test_hutch_on_sharded_matches_unsharded(pool, ws):
	"""Same seed ⇒ the same estimate, sharded or not, on every rank."""
	n = 96
	r = _one(pool.run("hutch_same_seed", kind="bsr", n=n, ws=ws))
	assert np.isclose(r["est"], r["ref"], rtol=1e-12, atol=0)
	assert abs(r["est"] - _laplacian(n).diagonal().sum()) < 10 / np.sqrt(n) * 3


def test_lanczos_on_sharded(pool):
	n = 96
	r = _one(pool.run("rayleigh_ritz", n=n))
	assert np.allclose(np.sort(r["rw"]), np.linalg.eigvalsh(_laplacian(n).toarray()), atol=1e-8)


def test_probe_axis_sharding(pool):
	n = 64
	A = _laplacian(n)
	r = _one(pool.run("bsr_apply", kind="lap", n=n, comm="halo", seed=8, k=6, shape=[2, 2], probe="probe"))
	V = np.random.default_rng(8).normal(size=(n, 6))
	_close(r["got"], A @ V)
	_close(r["got_t"], (A @ V).T)
	jop = jax_shard(A, jax_mesh((4, 2), ("op", "probe")), probe_axis="probe", comm="halo", blocksize=(8, 8))
	_close(r["got"], np.asarray(jop.matmat(jnp.asarray(V))))


@pytest.mark.parametrize("n", [128, 121])
def test_sharded_dia_matmat(pool, mesh8, n):
	A = _laplacian(n)
	r = _one(pool.run("dia_apply", n=n))
	V = np.random.default_rng(3).normal(size=(n, 5))
	assert r["isdia"]
	_close(r["got"], A @ V)
	_close(r["got_t"], (A @ V).T)
	_close(r["dense"], A.toarray())
	jop = jax_shard(JaxDIA.from_scipy(A), mesh8)
	_close(r["got"], np.asarray(jop.matmat(jnp.asarray(V))))
	_close(r["got_t"], np.asarray(jop.matmat_t(jnp.asarray(V.T))))


def test_sharded_dia_wide_band_and_probe_axis(pool):
	from primate_tpu.parallel import ShardedDIAOperator

	n, offsets = 96, [-7, -2, 0, 2, 7]
	r = _one(pool.run("dia_apply", n=n, offsets=offsets, probe="probe", shape=[2, 2], seed=9, k=6))
	rng = np.random.default_rng(9)
	A = sps.diags([rng.normal(size=n - abs(o)) for o in offsets], offsets).tocsr()
	V = rng.normal(size=(n, 6))
	_close(r["got"], A @ V)
	jop = ShardedDIAOperator.from_dia(A.todia(), jax_mesh((4, 2), ("op", "probe")), probe_axis="probe")
	_close(r["got"], np.asarray(jop.matmat(jnp.asarray(V))))


def test_sharded_dia_halo_too_wide_raises(pool):
	r = _one(pool.run("dia_halo_too_wide"))
	assert str(r["raised"]).startswith("ValueError") and "halo" in str(r["raised"])


@pytest.mark.parametrize("ws", [1, 2, 4])
def test_hutch_on_sharded_dia_matches_unsharded(pool, ws):
	r = _one(pool.run("hutch_same_seed", kind="dia", ws=ws))
	assert np.isclose(r["est"], r["ref"], rtol=1e-12, atol=0)


def test_matrix_function_on_sharded(pool):
	"""SLQ logdet on a sharded Laplacian, the sweep on the rank's rows with full re-orthogonalisation."""
	r = _one(pool.run("slq", kind="bsr", n=96, deg=40, orth=40, count=312, batch=24, seed=13))
	true = np.linalg.slogdet(r["dense"])[1]
	assert abs(r["est"] - true) / abs(true) < 0.05
	assert np.isclose(r["est"], r["ref"], rtol=1e-12, atol=0)


def test_all_estimators_on_sharded(pool):
	"""hutchpp / xtrace / diag / xdiag / cg all run on a sharded operator (marked slow in JAX,
	whose compile dominates; here it takes a second)."""
	r = _one(pool.run("all_estimators"))
	A = r["A"]
	tr = float(np.trace(A))
	assert abs(r["hutchpp"] - tr) / tr < 0.1
	assert abs(r["xtrace"] - tr) / tr < 0.02
	assert np.abs(r["diag"] - np.diag(A)).mean() < 0.6
	assert abs(r["xdiag"].sum() - tr) / tr < 0.15
	assert np.allclose(A @ r["x"], r["b"], atol=1e-6)


def test_kpm_on_sharded_dia_matches_unsharded(pool, mesh8):
	n = 256
	r = _one(pool.run("kpm", n=n))
	_close(r["ms"], r["ml"])
	assert np.isclose(r["est_s"], r["est_l"], rtol=1e-12, atol=0)
	jop = jax_shard(JaxDIA.from_scipy(_laplacian(n)), mesh8)
	V = np.random.default_rng(9).normal(size=(n, 4))
	M_j = pt.ChebyshevFunction(jop, fun="exp", deg=48, interval=(0.0, 6.5))
	_close(r["ms"], np.asarray(M_j.matmat(jnp.asarray(V))))


def test_eigsh_on_sharded_operator(pool):
	n = 256
	r = _one(pool.run("eigsh", n=n))
	ew = np.sort(3.0 - 2.0 * np.cos(np.arange(1, n + 1) * np.pi / (n + 1)))
	assert np.allclose(np.sort(r["w"]), ew[-3:], atol=1e-5)


def test_xnystrace_on_sharded_operator(pool):
	n = 256
	r = _one(pool.run("xnystrace", n=n))
	assert abs(r["est"] - 3.0 * n) < 0.02 * 3.0 * n


def test_deflated_trace_on_sharded_operator(pool):
	n = 256
	r = _one(pool.run("deflated_trace", n=n))
	assert abs(r["est"] - 3.0 * n) < 10 / np.sqrt(n) * 3.0


def test_stacked_family_on_sharded(pool):
	n, ts = 96, [0.25, 1.0]
	r = _one(pool.run("slq", kind="dia", n=n, deg=40, orth=40, count=512, batch=64, seed=17, ts=ts))
	w = np.linalg.eigvalsh(r["dense"])
	gt = np.array([np.sum(np.exp(-t * w)) for t in ts])
	assert r["est"].shape == (2,) and np.allclose(r["est"], gt, rtol=0.1)
	assert np.allclose(r["est"], r["ref"], rtol=1e-12, atol=0)


def test_auto_shard_shuffled_band_becomes_dia(pool):
	r = _one(pool.run("auto_shuffled"))
	assert str(r["format"]) == "dia" and r["perm"] and r["isdia"]
	_close(r["got"], r["want"])


def test_auto_shard_trace_matches_unsharded(pool):
	r = _one(pool.run("auto_trace"))
	assert np.isclose(r["est"], r["ref"], rtol=1e-10, atol=0)


def test_auto_shard_scattered_keeps_general_sparsity(pool):
	A = _random_sym_sparse(256, seed=9)
	r = _one(pool.run("auto_scattered"))
	assert str(r["format"]) in ("csr", "bsr") and not r["perm"]
	if str(r["format"]) == "csr":
		assert r["iscsr"]
	_close(r["got"], A @ np.random.default_rng(10).normal(size=(256, 4)))


def test_sharded_csr_scattered_allgather(pool):
	"""Scattered CSR: exact apply, and nnz-proportional storage (the ranks' nonzeros are A's)."""
	A = _random_sym_sparse(300, seed=11)
	res = pool.run("csr_apply", kind="rsym", n=300)
	assert sum(int(x["local_nnz"]) for x in res) == A.nnz
	r = _one(res)
	assert r["comm"] == "allgather"
	_close(r["got"], A @ np.random.default_rng(12).normal(size=(300, 5)))
	_close(r["dense"], A.toarray(), tol=0)


def test_sharded_csr_banded_halo(pool):
	n = 277  # uneven rows per rank on purpose
	A = _laplacian(n)
	r = _one(pool.run("csr_apply", kind="lap", n=n, seed=13, k=6))
	assert r["comm"] == "halo"
	V = np.random.default_rng(13).normal(size=(n, 6))
	_close(r["got"], A @ V)
	_close(r["got_t"], (A @ V).T)
	raised = _one(pool.run("csr_halo_scattered_raises"))["raised"]
	assert str(raised).startswith("ValueError")


def test_sharded_csr_skewed_rows_segment_path(pool):
	"""A power-law row distribution (JAX's segment-sum path) stays exact through cuSPARSE's layout."""
	n = 320
	S = sps.random(n, n, density=0.004, random_state=15).tolil()
	S[0, :250] = 1.0
	S = (S + S.T).tocsr()
	r = _one(pool.run("csr_apply", kind="skew", n=n, comm="allgather", seed=16, k=3))
	_close(r["got"], S @ np.random.default_rng(16).normal(size=(n, 3)))


def test_sharded_csr_estimators_match_unsharded(pool):
	r = _one(pool.run("slq", kind="csr_spd", n=256, deg=16, orth=4, count=64, batch=32, seed=21))
	true = np.log(np.linalg.eigvalsh(r["dense"])).sum()
	assert abs(float(r["est"]) - true) < 0.1 * abs(true)
	assert np.isclose(r["est"], r["ref"], rtol=1e-12, atol=0)


def test_shard_operator_blocksize_optin_warns(pool):
	r = _one(pool.run("blocksize_optin_warns"))
	assert r["warned"] and r["isbsr"]


def test_eigensolvers_on_sharded_operator(pool):
	n = 512
	r = _one(pool.run("eigensolvers", n=n))
	lam = np.sort(3.0 - 2.0 * np.cos(np.arange(1, n + 1) * np.pi / (n + 1)))
	assert np.abs(np.sort(r["w"]) - lam[:3]).max() < 1e-5
	sl = (lam >= 2.5) & (lam <= 2.7)
	assert len(r["wf"]) == int(np.count_nonzero(sl))
	assert np.abs(np.sort(r["wf"]) - lam[sl]).max() < 1e-8


def test_sharded_csr_kwarg_compat_and_rect_halo(pool):
	r = _one(pool.run("csr_kwarg_compat"))
	assert r["iscsr"]
	_close(r["got"], _random_sym_sparse(128, seed=31) @ np.random.default_rng(32).normal(size=(128, 3)))
	assert str(r["raised"]).startswith("ValueError") and "square" in str(r["raised"])


def test_sharded_dense_uneven_rows_and_dtype(pool):
	"""37 rows over 4 ranks, float32 by ``dtype=``."""
	r = _one(pool.run("dense_uneven"))
	rng = np.random.default_rng(41)
	A = rng.normal(size=(37, 37))
	A = (A + A.T) / 2
	V = rng.normal(size=(37, 3))
	assert str(r["dtype"]) == "torch.float32" and tuple(r["shape"]) == (37, 37)
	assert np.allclose(r["got"], A @ V, atol=1e-4)
	assert np.allclose(r["got_t"], (A @ V).T, atol=1e-4)
	assert np.allclose(r["rv"], A.T @ V[:, 0], atol=1e-4)


def test_sharded_bsr_halo_survives_empty_block_rows(pool):
	n = 128
	L = _laplacian(n).tolil()
	L[40:48, :] = 0.0
	L[:, 40:48] = 0.0
	L = L.tocsr()
	r = _one(pool.run("bsr_empty_block_rows", n=n))
	assert str(r["comm"]) == "halo"
	_close(r["got"], L @ np.random.default_rng(43).normal(size=(n, 3)))


def test_sharded_csr_minimal_halo_width(pool):
	n = 1000
	V = np.random.default_rng(51).normal(size=(n, 4))
	r = _one(pool.run("csr_apply", kind="lap", n=n, seed=51, k=4))
	assert str(r["comm"]) == "halo" and int(r["halo"]) == 1
	_close(r["got"], _laplacian(n) @ V)
	B = sps.diags([np.ones(n - 7), 3.0 * np.ones(n), np.ones(n - 7)], [-7, 0, 7]).tocsr()
	rb = _one(pool.run("csr_apply", kind="band7", n=n, seed=51, k=4))
	assert str(rb["comm"]) == "halo" and int(rb["halo"]) == 7
	_close(rb["got"], B @ V)
	_close(rb["dense"], B.toarray(), tol=0)


def test_sharded_bsr_minimal_halo_width(pool):
	n = 512
	A = _laplacian(n)
	r = _one(pool.run("bsr_apply", kind="lap", n=n, comm="auto", seed=61, k=4))
	assert r["isbsr"] and str(r["comm"]) == "halo" and int(r["halo"]) == 1
	_close(r["got"], A @ np.random.default_rng(61).normal(size=(n, 4)))
	_close(r["dense"], A.toarray(), tol=0)


def test_sharded_probe_major_matmat_t(pool, mesh8):
	"""Probe-major applies on sharded CSR and BSR (halo and allgather), then SLQ through them."""
	n = 256
	Vt = np.random.default_rng(71).normal(size=(n, 5)).T  # the block the ranks draw
	for A, kind, comm in ((_laplacian(n), "lap", "halo"), (_random_sym_sparse(n, seed=73), "rsym", "allgather")):
		r = _one(pool.run("csr_apply", kind=kind, n=n, seed=71, k=5))
		assert str(r["comm"]) == comm
		_close(r["got_t"], (A @ Vt.T).T)
	for A, kind, comm in ((_laplacian(n), "lap", "halo"), (_random_sym_sparse(n, seed=79), "rsym", "allgather")):
		res = pool.run("bsr_apply", kind=kind, n=n, comm="auto", seed=71, k=5, mseed=79)
		r = _one(res)
		assert str(r["comm"]) == comm
		_close(r["got_t"], (A @ Vt.T).T)
		jop = jax_shard(A, mesh8, comm="auto", blocksize=(8, 8))
		_close(r["got_t"], np.asarray(jop.matmat_t(jnp.asarray(Vt))))
	est = _one(pool.run("csr_slq_probe_major", n=n))["est"]
	true = np.linalg.slogdet(_laplacian(n).toarray())[1]
	assert abs(float(est) - true) / abs(true) < 0.05


def test_halo_explicit_zero_block_out_of_band(pool, mesh8):
	"""A stored zero far outside the band (block (0, 60)) keeps comm='halo', and every rank's block
	columns lie inside its halo window."""
	n = 512
	A = _laplacian(n).tocsr()
	Z = sps.csr_matrix((np.array([1.0]), (np.array([0]), np.array([480]))), shape=A.shape)
	A = (A + Z).tocsr()
	A.data[np.flatnonzero(A.indices[: A.indptr[1]] == 480)] = 0.0
	res = pool.run("bsr_apply", kind="lap", n=n, comm="halo", seed=7, k=3, zero_at=480)
	for x in res:
		window = int(x["bpd"]) + 2 * int(x["halo"])
		assert x["colids"].min() >= 0 and x["colids"].max() < window
	r = _one(res)
	assert str(r["comm"]) == "halo"
	V = np.random.default_rng(7).normal(size=(n, 3))
	_close(r["got"], A @ V)
	_close(r["got_t"], (A @ V).T)
	_close(r["got"], np.asarray(jax_shard(A, mesh8, comm="halo", blocksize=(8, 8)).matmat(jnp.asarray(V))))


# -- counterparts of tests/test_property.py's two sharded cases ---------------------------------


@settings(max_examples=20, deadline=None)
@given(
	n=st.integers(17, 96),
	bw=st.integers(0, 12),
	seed=st.integers(0, 10_000),
	ndev=st.sampled_from([1, 2, 4]),
	comm=st.sampled_from(["auto", "allgather"]),
)
def test_sharded_csr_random_band_matches_scipy(pool, n, bw, seed, ndev, comm):
	r = _one(pool.run("random_band_csr", n=n, bw=bw, seed=seed, ndev=ndev, comm=comm))
	_close(r["got"], r["want"])
	_close(r["got_t"], r["want"].T)


@settings(max_examples=12, deadline=None)
@given(nb=st.integers(3, 12), bs=st.sampled_from([2, 4, 8]), seed=st.integers(0, 10_000), ndev=st.sampled_from([2, 4]))
def test_sharded_bsr_random_tridiag_blocks_match_scipy(pool, nb, bs, seed, ndev):
	"""Including nb < 4 block rows over 4 ranks: ranks that hold no rows."""
	r = _one(pool.run("random_tridiag_bsr", nb=nb, bs=bs, seed=seed, ndev=ndev))
	assert np.allclose(r["got"], r["want"], atol=1e-4)


def test_sharded_bsr_fewer_block_rows_than_ranks(pool):
	"""The property's corner kept as a fixed case: 3 block rows over 4 ranks."""
	r = _one(pool.run("random_tridiag_bsr", nb=3, bs=4, seed=1, ndev=4))
	assert np.allclose(r["got"], r["want"], atol=1e-4)


# -- the sweep's row-sharded carry and the collectives --------------------------------------------


_SWEEPS = [
	("dia", 0, [4, 1], None, None),
	("dia", 5, [4, 1], None, None),
	("dia", 0, [2, 2], None, "probe"),
	("dia", 5, [2, 2], None, "probe"),
	("dia", 0, [2, 1], [0, 1], None),
	("dia", 0, [1, 1], [0], None),
	("bsr", 0, [4, 1], None, None),
	("bsr", 3, [2, 2], None, "probe"),
	("bsr_ag", 0, [4, 1], None, None),
	("csr", 5, [4, 1], None, None),
	("dense", 0, [4, 1], None, None),
]


@pytest.mark.parametrize("kind,orth,shape,ranks,probe", _SWEEPS)
def test_sweep_on_the_ranks_rows_matches_unsharded(pool, kind, orth, shape, ranks, probe):
	"""The Lanczos sweep on the local face (the rank's rows and probe slice, halo-extended carry,
	sums over the op group): α, β, the basis, f(A)V (one pass) and the quadratic forms against the
	unsharded port on the same block, and every rank alike."""
	n, deg, nv = 90, 14, 4
	r = _one(pool.run("sweep", kind=kind, n=n, deg=deg, orth=orth, nv=nv, shape=shape, ranks=ranks, probe=probe, two_pass=False))
	for key in ("a", "b", "Q", "f", "q"):
		_close(r["s" + key], r["u" + key])


@pytest.mark.parametrize("orth,selective,two_pass", [(0, False, True), (3, False, True), (14, True, False)])
def test_sweep_two_pass_and_selective_on_the_ranks_rows(pool, orth, selective, two_pass):
	"""f(A)V in two passes (the coefficients' running sum y on the rank's rows) and selective
	re-orthogonalisation (ω's β estimate summed over the op group) match the unsharded port."""
	r = _one(pool.run("sweep", kind="dia", n=90, deg=14, orth=orth, nv=4, shape=[2, 2], probe="probe", selective=selective, two_pass=two_pass))
	for key in ("a", "b", "Q", "f", "q"):
		_close(r["s" + key], r["u" + key])


def test_sweep_quad_matches_jax_sharded(pool, tmp_path):
	"""``MatrixFunction.quad`` on the sharded DIA operator's sweep against the JAX package's, on its
	8-device mesh, with the same probe block."""
	n, deg, nv = 120, 16, 8
	V = np.random.default_rng(5).normal(size=(n, nv))
	np.savez(tmp_path / "V.npz", V=V)
	r = _one(pool.run("sweep", kind="dia", n=n, deg=deg, orth=0, nv=nv, shape=[2, 2], probe="probe", path=str(tmp_path / "V.npz")))
	jop = jax_shard(JaxDIA.from_scipy(_laplacian(n)), jax_mesh((8, 1), ("op", "probe")))
	M = pt.MatrixFunction(jop, fun="log", deg=deg, orth=0)
	_close(r["sq"], np.asarray(M.quad(jnp.asarray(V))))


def _band(n: int, seed: int = 12) -> sps.csr_matrix:
	"""The workers' ``band``: ±1, ±7, ±40 off the diagonal, diagonally dominant."""
	rng = np.random.default_rng(seed)
	offs = (1, 7, 40)
	A = sps.diags([rng.uniform(-0.3, 0.3, size=n - o) for o in offs], offs)
	return (A + A.T + 3.0 * sps.eye(n)).tocsr()


# (n, orth, shape, ranks, probe): 1, 2 and 4 ranks, with and without a probe axis; n = 998 leaves
# the last of 4 ranks 248 rows and 2 zero ones.
_BAND_SWEEPS = [
	(1000, 0, [1, 1], [0], None),
	(998, 5, [1, 1], [0], None),
	(998, 0, [2, 1], [0, 1], None),
	(1000, 5, [2, 1], [0, 1], None),
	(998, 0, [4, 1], None, None),
	(1000, 5, [4, 1], None, None),
	(1000, 0, [2, 2], None, "probe"),
	(998, 5, [2, 2], None, "probe"),
]


@pytest.mark.parametrize("n,orth,shape,ranks,probe", _BAND_SWEEPS)
def test_sharded_dia_sweep_runs_the_step_kernels(pool, mesh8, n, orth, shape, ranks, probe):
	"""The sharded DIA sweep of a ±40 band on the padded carry goes through the step kernels'
	wrappers (``lanczos_dia_sweep_step`` at ``orth = 0``, ``lanczos_dia_step`` at 5, deg times, as the
	unsharded operator does), and its α, β, basis, f(A)V and quad match the unsharded port at 1e-10
	(float64); on the full mesh its quad also matches the JAX package's sharded operator."""
	deg, nv = 14, 4
	r = _one(pool.run("band_sweep", n=n, deg=deg, orth=orth, nv=nv, shape=shape, ranks=ranks, probe=probe))
	want_calls = [deg, 0] if orth == 0 else [0, deg]
	assert r["scalls"].tolist() == want_calls and r["ucalls"].tolist() == want_calls
	for key in ("a", "b", "Q", "f", "q"):
		_close(r["s" + key], r["u" + key], tol=1e-10)
	if shape == [4, 1]:
		V = np.random.default_rng(0).normal(size=(n, nv))
		jop = jax_shard(JaxDIA.from_scipy(_band(n)), mesh8)
		_close(r["sq"], np.asarray(pt.MatrixFunction(jop, fun="log", deg=deg, orth=orth).quad(jnp.asarray(V))), tol=1e-10)


@pytest.mark.parametrize("shape,ranks,probe", [([2, 1], [0, 1], None), ([4, 1], None, None), ([2, 2], None, "probe")])
def test_sharded_bf16_sweep_runs_the_round_step(pool, shape, ranks, probe):
	"""The bf16 sweep without re-orthogonalisation on a sharded DIA operator (tridiag(−1, 3, −1),
	n = 2048, 8 Rademacher probes, deg 12, as the two-rank test of ``test_torch_bf16.py``) goes through
	``lanczos_dia_round_step`` once a step and through no other step wrapper, as the unsharded operator
	does, and its α and β match the unsharded port within 1e-3 relative (q is rounded to bf16 every
	step; the sums are taken rank by rank)."""
	deg = 12
	r = _one(pool.run("bf16_round_sweep", n=2048, deg=deg, nv=8, shape=shape, ranks=ranks, probe=probe))
	assert r["scalls"].tolist() == [deg, 0, 0] and r["ucalls"].tolist() == [deg, 0, 0]
	for key in ("a", "b"):
		assert np.abs(r["s" + key] - r["u" + key]).max() <= 1e-3 * np.abs(r["u" + key]).max()


@pytest.mark.parametrize("ws", [1, 2, 4])
@pytest.mark.parametrize("kind", ["plain", "basis", "fav", "breakdown", "deg1"])
def test_sharded_sweep_deferred_finish_is_the_eager_sweep(pool, mesh8, kind, ws):
	"""A row-sharded DIA step leaves its finish (α, β, the divisors, the done flags) to the next step's pass A, or
	to a standalone finish where the sweep reads the state between steps (the basis, f(A)V's ``y``) and at its end.
	On ``ws`` gloo ranks that composition gives the eager sharded sweep's α, β, basis, f(A)V and quad bit for bit,
	runs one standalone finish a sweep (``deg`` where the state is read between steps), agrees with the unsharded
	port at 1e-10 as before (float64), and its quad with the JAX package's sharded operator at 1e-10. ``breakdown``:
	a probe whose β vanishes at step 3; ``deg1``: a one-step sweep."""
	n, nv = 120, 4
	deg = 1 if kind == "deg1" else 10
	r = _one(pool.run("deferred_finish", kind="plain" if kind == "deg1" else kind, n=n, deg=deg, nv=nv, ws=ws))
	for key in [k[1:] for k in r if k.startswith("e")]:
		if key.endswith("finishes"):
			continue
		assert np.array_equal(r["d" + key], r["e" + key]), f"the deferred sweep's {key} differs from the eager one's"
	assert int(r["dfinishes"]) == (deg if kind == "basis" else 1) and int(r["efinishes"]) == 0
	if kind == "fav":
		assert int(r["dffinishes"]) == deg
	_close(r["da"], r["ua"], tol=1e-10)
	_close(r["db"], r["ub"], tol=1e-10)
	if kind == "breakdown":
		assert np.all(r["da"][3:, 0] == 0) and np.all(r["db"][3:, 0] == 0) and r["db"][2, 0] < 1e-6
	A = _laplacian(n).tolil()
	if kind == "breakdown":
		A[2, 3] = A[3, 2] = 0.0
	V = np.random.default_rng(7).normal(size=(n, nv))
	if kind == "breakdown":
		V[3:, 0] = 0.0
	if deg == 1:
		return
	jop = jax_shard(JaxDIA.from_scipy(A.tocsr()), mesh8)
	_close(r["dq"], np.asarray(pt.MatrixFunction(jop, fun="log", deg=deg, orth=0).quad(jnp.asarray(V))), tol=1e-10)


@pytest.mark.parametrize("ws", [1, 2, 4])
def test_sharded_bf16_round_pair_finishes_in_b2(pool, ws):
	"""The sharded bf16 step's finish runs in B2 (``lanczos_round_pair_ref``: B1's Σv² all-reduced, then the finish
	and q_next from the reduced sums, no standalone finish): on ``ws`` gloo ranks α and β equal, bit for bit, the
	sweep through the round pair's plain version in one piece (``lanczos_dia_round_ref``)."""
	r = _one(pool.run("deferred_round_finish", n=2048, deg=12, nv=8, ws=ws))
	assert np.array_equal(r["da"], r["ea"]) and np.array_equal(r["db"], r["eb"])
	assert int(r["dfinishes"]) == 0


@pytest.mark.parametrize("ws", [2, 4])
def test_halo_exchange_and_gather_rows(pool, ws):
	res = [x for x in pool.run("comm_primitives", ws=ws) if x is not None]
	h, nl = 2, 5
	for r, x in enumerate(res):
		X = x["X"]
		left = np.zeros((3, h)) if r == 0 else np.tile(np.arange(nl - h, nl) + 10 * (r - 1), (3, 1))
		right = np.zeros((3, h)) if r == ws - 1 else np.tile(np.arange(h) + 10 * (r + 1), (3, 1))
		assert np.array_equal(X[:, :h], left) and np.array_equal(X[:, h + nl :], right)
		assert np.array_equal(x["y"][:, 0], np.repeat(np.arange(1, ws + 1), 2)[: 2 * ws - 1])
		# d/dx of Σ_ranks Σ (r' + 1)·y over the gathered rows the rank's block lands on (the last
		# rank's second row is cut off by n = 2·ws − 1).
		want = np.full((2, 3), ws * (ws + 1) / 2)
		if r == ws - 1:
			want[1] = 0.0
		assert np.array_equal(x["grad"], want)
