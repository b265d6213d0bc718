"""The on-device builder of the random block-sparse SPD matrix (``operators/block_random_spd.py``)
against its law (``reference/block_random_spd.py``): symmetric to the bit, every row strictly
dominant, the port's BSR product against the reference's float64 one, the draw the same in any
order and blocking and on either device, and at audikw_1's scale about 1,333,600 tiles."""

import time

import pytest
import torch

from port_bench import harness
from port_bench.reference import block_random_spd as law

builder = harness.load_module("operators", "block_random_spd")
SMALL = builder.EXAMPLE["params"]
# SuiteSparse GHS_psdef/audikw_1's scale: 943,695 rows, 77.65M nonzeros; benchmarks/matrices.py's host
# build of the same law at these sizes (seed 7, scipy's own draw) made 1,333,628 tiles.
AUDIKW = {"n": 1_048_576, "bs": 8, "density": 3.5e-5, "seed": 7}
AUDIKW_TILES = 1_333_588


def law_check(blocks: torch.Tensor, indices: torch.Tensor, indptr: torch.Tensor) -> dict:
	"""What the BSR arrays show of the law, on their own device: block rows sorted by column, the
	pattern and the tiles symmetric to the bit, one diagonal tile a block row, and the least margin
	of strict dominance, ``a_ii − Σ_{j≠i} |a_ij|``."""
	nb, bs = indptr.shape[0] - 1, blocks.shape[1]
	rows = torch.repeat_interleave(torch.arange(nb, device=blocks.device), indptr.diff())
	keys, mirror_keys = rows * nb + indices, indices * nb + rows
	mirror = torch.searchsorted(keys, mirror_keys).clamp_(max=keys.shape[0] - 1)
	diag = rows == indices
	a = blocks[diag].diagonal(dim1=1, dim2=2).double()
	rowabs = torch.zeros((nb, bs), dtype=torch.float64, device=blocks.device)
	rowabs.index_add_(0, rows, blocks.abs().double().sum(dim=2))
	return {
		"sorted": bool((keys.diff() > 0).all()),
		"symmetric": torch.equal(keys[mirror], mirror_keys) and torch.equal(blocks[mirror].transpose(1, 2), blocks),
		"diagonal_tiles": int(diag.sum()) == nb,
		"margin": float((a - (rowabs - a.abs())).min()),
	}


def test_small_matrix_keeps_the_law_and_applies_as_the_reference():
	import primate_tpu_torch as ptt

	blocks, indices, indptr, shape = builder.tiles(SMALL, torch.float32, "cpu")
	check = law_check(blocks, indices, indptr)
	assert check["sorted"] and check["symmetric"] and check["diagonal_tiles"] and check["margin"] > 0, check
	op = ptt.BSROperator(blocks, indices, indptr, shape)
	dense = op.todense()
	assert torch.equal(dense, dense.T)
	off = dense.abs().sum(dim=1) - dense.diagonal().abs()
	assert bool((dense.diagonal() > off).all())
	X = torch.randn(shape[0], 5, dtype=torch.float32, generator=torch.Generator().manual_seed(3))
	want = law.apply(SMALL, X.T.double()).T
	# float32 rounding of a row of about 80 terms beside a diagonal of about 45
	assert torch.allclose(op.matmat(X).double(), want, atol=1e-5)
	lo, hi = law.interval(SMALL)
	eig = torch.linalg.eigvalsh(dense.double())
	assert lo >= 1.0 and lo <= float(eig.min()) and float(eig.max()) <= hi


def test_draw_is_standard_normal_and_the_same_in_any_order_and_blocking(monkeypatch):
	keys = law.pattern(SMALL, "cpu")
	T = law.draw(SMALL, keys)
	z = T.double().reshape(-1)
	assert abs(float(z.mean())) < 5e-3 and abs(float(z.var()) - 1.0) < 1e-2
	perm = torch.randperm(keys.shape[0], generator=torch.Generator().manual_seed(1))
	assert torch.equal(law.draw(SMALL, keys[perm]), T[perm])
	monkeypatch.setattr(law, "CHUNK", 1000)
	assert torch.equal(law.draw(SMALL, keys), T)
	assert not torch.equal(law.draw({**SMALL, "seed": 8}, keys), T)


def test_pattern_at_audikw_scale():
	keys = law.pattern(AUDIKW, "cpu")
	nb = AUDIKW["n"] // AUDIKW["bs"]
	I, J = keys // nb, keys % nb
	assert keys.shape[0] == AUDIKW_TILES and abs(AUDIKW_TILES - 1_333_628) < 100
	assert torch.equal(torch.unique(J * nb + I), keys)
	assert int((I == J).sum()) == nb


def test_n_must_be_whole_tiles():
	with pytest.raises(ValueError, match="whole number"):
		law.dims({**SMALL, "n": 4100})


@pytest.mark.cuda
def test_card_builds_the_cpu_tiles(cuda_device):
	want = builder.tiles(SMALL, torch.float32, "cpu")
	got = builder.tiles(SMALL, torch.float32, cuda_device)
	for w, g in zip(want[:3], got[:3]):
		assert torch.equal(g.cpu(), w)
	assert got[3] == want[3]


@pytest.mark.cuda
def test_card_builds_the_audikw_scale_matrix_warm_in_under_two_seconds(cuda_device):
	builder.tiles(AUDIKW, torch.float32, cuda_device)
	torch.cuda.synchronize(cuda_device)
	t0 = time.perf_counter()
	blocks, indices, indptr, shape = builder.tiles(AUDIKW, torch.float32, cuda_device)
	torch.cuda.synchronize(cuda_device)
	seconds = time.perf_counter() - t0
	check = law_check(blocks, indices, indptr)
	print(f"block_random_spd at audikw_1's scale on {torch.cuda.get_device_name(cuda_device)}: {blocks.shape[0]} tiles, "
		f"{blocks.numel() * blocks.element_size()} bytes of float32 tiles, built warm in {seconds:.4f} s; {check}")
	assert blocks.shape[0] == AUDIKW_TILES and shape == (AUDIKW["n"], AUDIKW["n"])
	assert check["sorted"] and check["symmetric"] and check["diagonal_tiles"] and check["margin"] > 0, check
	assert seconds < 2.0
