"""Distributed differentiable GP-style training: a sharded operator and autograd (``examples/distributed_gp.py``).

* a banded kernel operator row-partitioned across the mesh's ``op`` axis (BSR tiles, ``comm="halo"``:
  each apply reads only the neighbouring ranks' boundary rows), with probes split along ``probe``;
* the SLQ logdet (:func:`~primate_tpu_torch.autodiff.logdet`: forward the Lanczos quadrature sweep on
  each rank's rows, backward ``tr(K⁻¹∂K)`` by batched CG through the same sharded applies) and the
  quadratic term by the differentiable CG solve;
* the gradient reaches each rank's tiles; every rank computes the same loss, so the gradient of the
  replicated parameter is averaged over the ranks, as ``DistributedDataParallel`` averages it.

The hyperparameter is a global scale on a banded precision matrix, ``K(s) = s·L + I`` with ``L`` the
path Laplacian, so the exact gradient ``d/ds`` is known in closed form and printed beside the
estimate. Data come from ``s* = 3``; the fit must land within 20% of it.

Run: ``python -m primate_tpu_torch.examples.distributed_gp`` (one rank on the card), or
:func:`launch` with ``world=4, device="cpu", backend="gloo"`` for four ranks on the host.
"""

import copy
import socket

import numpy as np
import scipy.sparse as sps
import torch
import torch.distributed as dist

import primate_tpu_torch as ptt
from primate_tpu_torch.operators.sparse import BSROperator
from primate_tpu_torch.parallel import initialize_distributed, make_mesh, shard_operator

S_TRUE = 3.0


def main(device=None, iters: int = 25, rows_per_rank: int = 128, lr: float = 0.002) -> dict:
	"""One rank's training run; every rank of the initialised process group calls it."""
	if not dist.is_initialized():
		raise RuntimeError("distributed_gp.main runs inside a process group: call launch(), or initialise one first")
	dev = torch.device(device or "cuda")
	world = dist.get_world_size()
	n_probe = 2 if (world % 2 == 0 and world >= 4) else 1
	mesh = make_mesh((world // n_probe, n_probe), ("op", "probe"), device_type=dev.type)
	n = mesh.size(0) * rows_per_rank

	off = -np.ones(n - 1, np.float32)
	L = sps.diags([off, 2.0 * np.ones(n, np.float32), off], [-1, 0, 1]).tocsr()
	Lop = shard_operator(L, mesh, probe_axis="probe", comm="halo", blocksize=(8, 8), device=dev)
	# The identity on L's own pattern, so its tiles line up with L's and add to them directly.
	E = L.copy()
	E.data[:] = 0.0
	E.setdiag(1.0)
	eye_tiles = shard_operator(E.tocsr(), mesh, probe_axis="probe", comm="halo", blocksize=(8, 8), device=dev).local.blocks

	def K_of(s: torch.Tensor):
		"""``K(s) = s·L + I`` as a sharded operator: L's partition with its rank's tiles scaled."""
		K = copy.copy(Lop)
		loc = Lop.local
		K.local = BSROperator(s * loc.blocks + eye_tiles, loc.indices, loc.indptr, loc.shape)
		return K

	rng = np.random.default_rng(0)
	K_true = (S_TRUE * L + sps.eye(n)).toarray()
	y_np = np.linalg.cholesky(K_true) @ rng.normal(size=n)
	y = torch.tensor(y_np, dtype=torch.float32, device=dev)

	lam, U = np.linalg.eigh(L.toarray())
	z2 = (U.T @ y_np) ** 2

	def exact_grad(theta: float) -> float:
		"""``d/dθ`` of ``0.5·(logdet K + yᵀK⁻¹y)`` at ``s = e^θ``, in L's eigenbasis:
		``tr(K⁻¹L) − yᵀK⁻¹LK⁻¹y``, times ``s`` by the chain rule."""
		s = float(np.exp(theta))
		return 0.5 * (np.sum(lam / (s * lam + 1)) - np.sum(lam * z2 / (s * lam + 1) ** 2)) * s

	theta = torch.zeros((), dtype=torch.float32, device=dev, requires_grad=True)  # s₀ = 1
	if dist.get_rank() == 0:
		print(f"mesh {tuple(mesh.shape)}  n={n}  (maximize p(y | s·L + I); true s* = {S_TRUE})")
	history = []
	for it in range(iters):
		K = K_of(torch.exp(theta))
		ld = ptt.autodiff.logdet(K, deg=16, orth=8, nv=32, seed=1000 + it)
		alpha = ptt.solve(K, y, rtol=1e-6)
		nll = 0.5 * (ld + y @ alpha)
		(g,) = torch.autograd.grad(nll, theta)
		dist.all_reduce(g)  # every rank computed the same loss: average the gradient over the ranks
		g = g / world
		with torch.no_grad():
			theta -= lr * g
		history.append((float(nll.detach()), float(g), exact_grad(float(theta.detach()))))
		if it % 4 == 0 and dist.get_rank() == 0:
			print(f"  it {it:2d}: s={float(torch.exp(theta.detach())):.3f}  nll={history[-1][0]:9.3f}  grad={history[-1][1]:8.3f}  "
				f"exact={history[-1][2]:8.3f}")
	s_fit = float(torch.exp(theta.detach()))
	if dist.get_rank() == 0:
		print(f"fitted s = {s_fit:.3f} (true {S_TRUE}) on {world} ranks")
	assert abs(s_fit - S_TRUE) / S_TRUE < 0.2, s_fit
	return {"s_fit": s_fit, "n": n, "world": world, "mesh": tuple(mesh.shape), "history": history}


def _rank(rank: int, world: int, port: int, backend: str, device, kwargs: dict, queue) -> None:
	import traceback

	initialize_distributed(backend, init_method=f"tcp://localhost:{port}", world_size=world, rank=rank)
	try:
		if device is None or torch.device(device).type == "cuda":
			torch.cuda.set_device(rank % torch.cuda.device_count())
		else:
			torch.set_num_threads(1)
		queue.put((rank, main(device, **kwargs)))
	except Exception:
		queue.put((rank, {"error": traceback.format_exc()}))
	finally:
		dist.destroy_process_group()


def launch(world: int = 1, device=None, backend=None, timeout: float = 600.0, **kwargs) -> list:
	"""Run :func:`main` on ``world`` ranks, each a process on this host (on the card by default,
	over NCCL; ``device="cpu", backend="gloo"`` on the host). Returns each rank's result."""
	import multiprocessing as mp

	with socket.socket() as s:
		s.bind(("localhost", 0))
		port = s.getsockname()[1]
	ctx = mp.get_context("spawn")
	queue = ctx.Queue()
	backend = backend or ("gloo" if device is not None and torch.device(device).type == "cpu" else "nccl")
	procs = [ctx.Process(target=_rank, args=(r, world, port, backend, device, kwargs, queue)) for r in range(world)]
	for p in procs:
		p.start()
	results = {}
	try:
		for _ in range(world):
			rank, out = queue.get(timeout=timeout)
			results[rank] = out
	finally:
		for p in procs:
			p.join(timeout=30)
			if p.is_alive():
				p.kill()
				p.join()
	errors = [out["error"] for out in results.values() if "error" in out]
	if errors:
		raise RuntimeError(f"distributed_gp: a rank failed:\n{errors[0]}")
	return [results[r] for r in range(world)]


if __name__ == "__main__":
	launch()
