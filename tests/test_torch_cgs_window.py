"""The CGS window of the re-orthogonalised Lanczos step (``primate_tpu_torch.ops.cgs``) on the CPU: the
host's slot bitmask against the tensor masks the sweep built before, the launches' slot groups, and the
CPU window against the PyTorch ops of the sweep bit for bit. The kernels themselves are held to the plain
version on the card (``tests/test_torch_cuda_kernels.py``, ``cuda``)."""

import numpy as np
import pytest
import torch

from primate_tpu_torch.ops import _common
from primate_tpu_torch.ops.cgs import KHOLD, CgsWindow, cgs_window_ref, slot_groups, slot_mask
from primate_tpu_torch.ops.dia import row_sq_norm


def _bits(valid: torch.Tensor) -> int:
	return sum(1 << s for s, ok in enumerate(valid.tolist()) if ok)


@pytest.mark.parametrize("ncv", range(1, 21))
def test_slot_mask_matches_the_tensor_masks(ncv):
	"""``slot_mask`` equals ``(age < orth) & (age <= j)`` and the selective ``age <= j`` with
	``age = (j − slot) mod ncv``, for every step j and window length orth up to 20."""
	slot_ids = torch.arange(ncv)
	for j in range(21):
		age = (j - slot_ids) % ncv
		assert slot_mask(j, ncv, ncv, selective=True) == _bits(age <= j)
		for orth in range(1, ncv + 1):
			assert slot_mask(j, orth, ncv) == _bits((age < orth) & (age <= j))
			assert slot_mask(j, orth, ncv, selective=True) == _bits(age <= j)


@pytest.mark.parametrize("ncv", [1, 5, 8, 9, 20, 64, 65, 200])
def test_slot_groups_cover_the_mask_in_launches_of_held_slots(ncv):
	"""Every valid slot lands in exactly one launch; a launch holds at most ``KHOLD`` slots, each within 64
	ages of its first."""
	rng = np.random.default_rng(ncv)
	masks = [slot_mask(j, orth, ncv, sel) for j in (0, 3, ncv - 1, ncv + 7) for orth in (1, 5, ncv) for sel in (False, True)]
	masks += [int(sum(1 << int(s) for s in rng.choice(ncv, size=min(ncv, 30), replace=False)))]
	for mask in masks:
		for top in (None, ncv - 1, ncv // 2):
			slots = []
			for bits, first in slot_groups(mask, ncv, top):
				assert 0 < bits < 1 << 64 and bin(bits).count("1") <= KHOLD
				slots += [(first - b) % ncv for b in range(64) if (bits >> b) & 1]
			assert sorted(slots) == [s for s in range(ncv) if (mask >> s) & 1] and len(set(slots)) == len(slots)
	for j in range(3 * ncv):
		# A window's newest orth slots are one launch's low bits when they fit one, starting at q_j's slot.
		for orth in {1, min(5, ncv), min(KHOLD, ncv)}:
			mask = slot_mask(j, orth, ncv)
			assert slot_groups(mask, ncv, j % ncv) == [((1 << min(orth, j + 1)) - 1, j % ncv)]
			assert slot_groups(mask, ncv) == slot_groups(mask, ncv, j % ncv) or bin(mask).count("1") == ncv


def _old_tail(v, q_cur, alpha, Q_win, valid, passes):
	"""The re-orthogonalised step's tail as the sweep wrote it inline, on the rows of v."""
	v.addcmul_(alpha[:, None], q_cur.to(v.dtype), value=-1)
	Q_bra = Q_win.conj() if Q_win.is_complex() else Q_win
	for _ in range(max(1, passes)):
		proj = torch.sum(Q_bra * v[None, :, :], dim=2) * valid[:, None]
		v.sub_(torch.sum(Q_win * proj[:, :, None].to(v.dtype), dim=0))
	return row_sq_norm(v)


@pytest.mark.parametrize("dtype,win", [
	(torch.float32, torch.float32), (torch.float64, torch.float64), (torch.complex64, torch.complex64),
	(torch.complex128, torch.complex128), (torch.float32, torch.bfloat16), (torch.float32, torch.float16),
	(torch.float64, torch.float16),
])
@pytest.mark.parametrize("passes", [1, 2, 3])
def test_cpu_window_is_the_sweeps_pytorch_ops(dtype, win, passes):
	"""On the CPU the window runs the PyTorch ops the sweep ran inline, bit for bit, and counts no launch."""
	g = torch.Generator().manual_seed(passes)
	ncv, nv, n = 6, 3, 301
	Q = torch.randn((ncv, nv, n), generator=g, dtype=dtype).to(win)
	window = CgsWindow(Q)
	before = dict(_common.LAUNCHES)
	for j in range(ncv + 2):
		v = torch.randn((nv, n), generator=g, dtype=dtype)
		alpha = torch.randn(nv, generator=g, dtype=v.real.dtype)
		q = torch.randn((nv, n), generator=g, dtype=dtype).to(win if win == torch.bfloat16 else dtype)
		age = (j - torch.arange(ncv)) % ncv
		valid = ((age < 4) & (age <= j)).to(v.real.dtype)
		want_v = v.clone()
		want = _old_tail(want_v, q, alpha, Q, valid, passes)
		got = window(v, slot_mask(j, 4, ncv), passes, alpha, q)
		assert torch.equal(v, want_v) and torch.equal(got, want)
		assert torch.equal(cgs_window_ref(v.clone(), Q, 0, passes, alpha, q), row_sq_norm(v.addcmul(alpha[:, None], q.to(dtype), value=-1)))
	assert _common.LAUNCHES == before


def test_cpu_window_takes_q_cur_from_a_named_slot():
	"""``q_slot`` names the window's slot that holds q_cur: the same bits as handing that slot's rows."""
	g = torch.Generator().manual_seed(11)
	ncv, nv, n = 5, 3, 257
	Q = torch.randn((ncv, nv, n), generator=g)
	window = CgsWindow(Q)
	for j in range(ncv + 2):
		v = torch.randn((nv, n), generator=g)
		alpha = torch.randn(nv, generator=g)
		want_v = v.clone()
		want = window(want_v, slot_mask(j, 4, ncv), 2, alpha, Q[j % ncv])
		got = window(v, slot_mask(j, 4, ncv), 2, alpha, q_slot=j % ncv)
		assert torch.equal(v, want_v) and torch.equal(got, want)


def _path_op(dtype, n=200):
	import scipy.sparse as sps

	from primate_tpu_torch.operators import DIAOperator

	L = sps.diags([-np.ones(n - 1), 3.0 * np.ones(n), -np.ones(n - 1)], [-1, 0, 1]).tocsr()
	return DIAOperator.from_scipy(L.astype(np.complex128) if dtype.is_complex else L, device="cpu", dtype=dtype)


@pytest.mark.parametrize("dtype,basis", [
	(torch.float32, torch.float16), (torch.float32, torch.bfloat16), (torch.float32, torch.float64),
	(torch.float64, torch.float16), (torch.float64, torch.float32), (torch.complex64, torch.complex128),
	(torch.complex128, torch.complex64),
])
def test_basis_dtype_of_the_sweeps_kind_is_kept(dtype, basis):
	"""A window of the sweep's kind (any real floating width for a real sweep, either complex width for a complex
	one) is kept in ``basis_dtype``: the re-orthogonalised sweep's α and β lie within the window's rounding of the
	sweep that keeps it in the sweep's dtype."""
	from primate_tpu_torch.lanczos import lanczos_block_op

	op = _path_op(dtype)
	V0 = torch.from_numpy(np.random.default_rng(3).standard_normal((200, 4))).to(dtype)
	out = lanczos_block_op(op, V0, deg=12, ncv=5, orth=5, basis_dtype=basis)
	ref = lanczos_block_op(op, V0, deg=12, ncv=5, orth=5)
	assert out.Q.dtype == basis
	tol = 1e-2 if basis in (torch.float16, torch.bfloat16) else 1e-4
	assert float((out.alphas - ref.alphas).abs().max()) <= tol * float(ref.alphas.abs().max())
	assert float((out.betas - ref.betas).abs().max()) <= tol * float(ref.betas.abs().max())


@pytest.mark.parametrize("dtype,basis", [
	(torch.complex64, torch.float32), (torch.complex128, torch.float64), (torch.complex64, torch.bfloat16),
	(torch.float32, torch.complex64), (torch.float64, torch.complex128), (torch.float32, torch.int32),
])
@pytest.mark.parametrize("orth", [0, 5])
def test_basis_dtype_of_another_kind_raises(dtype, basis, orth):
	"""A real window of a complex sweep (it would drop the basis's imaginary parts), a complex window of a real
	sweep, or a window that is no floating type raises ``TypeError`` before the sweep runs, whatever the device."""
	from primate_tpu_torch.lanczos import lanczos_block_op

	op = _path_op(dtype)
	V0 = torch.ones((200, 2), dtype=dtype)
	with pytest.raises(TypeError, match="basis_dtype must be one of"):
		lanczos_block_op(op, V0, deg=8, ncv=5, orth=orth, basis_dtype=basis)


def _function_path_op(dtype, n=200):
	from primate_tpu_torch.operators.base import FunctionOperator

	D = _path_op(dtype, n)
	return FunctionOperator(D.matmat, D.shape, dtype=dtype, device="cpu")


@pytest.mark.parametrize("build,dtype", [
	(_path_op, torch.float32), (_function_path_op, torch.float32), (_function_path_op, torch.complex64),
	(_path_op, torch.complex128),
])
@pytest.mark.parametrize("kw", [dict(orth=5, ncv=5), dict(orth=5, ncv=5, return_basis=True), dict(ncv=8, selective=True)])
def test_sweep_hands_the_window_packed_rows(monkeypatch, build, dtype, kw):
	"""The re-orthogonalised sweep hands the window v's rows, q_cur's rows and α packed, as the kernels read them,
	whatever the operator's step hands back: a FunctionOperator's plain step a column-major v, a complex operator's
	plain step α as the real view of a complex sum."""
	from primate_tpu_torch.lanczos import lanczos_block_op

	seen = []
	call = CgsWindow.__call__

	def packed(self, v, mask, passes, alpha=None, q=None, q_slot=-1):
		seen.append(v.stride(-1) == 1 and (alpha is None or alpha.is_contiguous()) and (q is None or q.stride(-1) == 1))
		return call(self, v, mask, passes, alpha, q, q_slot)

	monkeypatch.setattr(CgsWindow, "__call__", packed)
	V0 = torch.from_numpy(np.random.default_rng(4).standard_normal((200, 3))).to(dtype)
	lanczos_block_op(build(dtype), V0, deg=10, **kw)
	assert len(seen) >= 10 and all(seen)
