"""The random symmetric block-sparse SPD matrix of ``reference/block_random_spd.py`` as BSR tiles,
built on the device from the raw draw: the pattern's sorted keys give the block rows in order,
each by block column; ``A_IJ = (T_IJ + T_JIᵀ)/2`` takes ``T_JI`` from the same draw, so ``A`` is
symmetric to the bit; the diagonal ``Σ_j |A_ij| + 1`` is summed in float64 in one fixed order on
every device and rounded once to float32."""

import torch

from ..reference import block_random_spd as law

# A small matrix of the same law, about 10 tiles a block row as at audikw_1's scale, for the tests.
EXAMPLE = {"format": "bsr", "dtype": "float32", "params": {"n": 4096, "bs": 8, "density": 0.009, "seed": 7}}


def _ordered_sum(x: torch.Tensor) -> torch.Tensor:
	"""The sum over the second axis, term after term: the same order, so the same bits, everywhere."""
	s = x[:, 0].clone()
	for j in range(1, x.shape[1]):
		s += x[:, j]
	return s


def tiles(params: dict, dtype: torch.dtype, device) -> tuple:
	_, bs, nb = law.dims(params)
	keys = law.pattern(params, device)
	I, J = keys // nb, keys % nb
	A = law.draw(params, keys)
	A.add_(A[torch.searchsorted(keys, J * nb + I)].transpose(1, 2)).mul_(0.5)
	counts = torch.bincount(I, minlength=nb)
	indptr = torch.cat([counts.new_zeros(1), counts.cumsum(0)])
	# Σ_j |A_ij| by row: over a tile's columns, then over the tiles of a block row laid side by side.
	per_tile = _ordered_sum(A.abs().double().permute(0, 2, 1))
	rows = torch.zeros((nb, int(counts.max()), bs), dtype=torch.float64, device=A.device)
	rows[I, torch.arange(I.shape[0], device=A.device) - indptr[I]] = per_tile
	diag = _ordered_sum(rows).add_(1.0).float()
	A.diagonal(dim1=1, dim2=2)[I == J] += diag
	n = nb * bs
	return A.to(dtype), J, indptr, (n, n)
