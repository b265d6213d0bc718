"""A random symmetric block-sparse matrix made strictly diagonally dominant, the law of
``benchmarks/matrices.py``'s ``block_random_spd``: a random symmetric pattern of ``bs × bs``
tiles at ``density`` plus every diagonal tile, each tile ``T`` drawn standard normal, then
``A = (T + Tᵀ)/2`` and ``diag(Σ_j |A_ij| + 1)`` added, so that every row is strictly dominant
and every eigenvalue is at least 1.

The draw is counter-based, so it gives the same bits on the CPU and on the card, in any order
and in any blocking: block ``(I, J)`` of the pattern is drawn ``density·nb²`` times with
replacement (draw ``i``'s row and column are hashes of ``(seed, stream, i)``, duplicates
dropped), and element ``e`` of tile ``(I, J)`` is a Box-Muller normal from two hashes of
``(seed, I·nb + J, e)``, worked in float64 and rounded once to float32. The hash works on
32-bit words held in int64, with multipliers below 2³¹, so no product leaves int64's range.

``draw`` and ``pattern`` are the raw draw that the benchmark's builder
(``operators/block_random_spd.py``) and this reference both take; the rest, the symmetric
part, the dominant diagonal and the product, the reference works out again in float64.
"""

import json
import math

import torch

M32 = 0xFFFFFFFF
PATTERN_ROWS, PATTERN_COLS, TILES = 1, 2, 3
# Elements drawn at once, so that a chunk's int64 and float64 temporaries stay near 100 MB each.
CHUNK = 2**24


def dims(params: dict) -> tuple:
	"""``(n, bs, nb)``; ``n`` has to be a whole number of tiles."""
	n, bs = int(params["n"]), int(params["bs"])
	if n % bs:
		raise ValueError(f"n = {n} is not a whole number of {bs} x {bs} tiles")
	return n, bs, n // bs


def size(params: dict) -> int:
	return dims(params)[0]


def _mix(x):
	"""A bijection of 32-bit words (xor-shift 15, multiply, xor-shift 12, multiply, xor-shift 15)."""
	x = x ^ (x >> 15)
	x = (x * 0x2C1B3C6D) & M32
	x = x ^ (x >> 12)
	x = (x * 0x297A2D39) & M32
	return x ^ (x >> 15)


def _hash(h, *words):
	for w in words:
		h = _mix(h ^ w)
	return h


def _key(params: dict, stream: int) -> int:
	seed = int(params["seed"])
	return _hash(_mix(seed & M32), (seed >> 32) & M32, stream)


def pattern(params: dict, device) -> torch.Tensor:
	"""The pattern's blocks as sorted keys ``I·nb + J`` (int64): the drawn blocks, their mirrors and
	the diagonal, each once. Sorted keys are the block rows in order, each by block column."""
	_, _, nb = dims(params)
	k = int(round(float(params["density"]) * nb * nb))
	i = torch.arange(k, dtype=torch.int64, device=device)
	r = _hash(_key(params, PATTERN_ROWS), i) % nb
	c = _hash(_key(params, PATTERN_COLS), i) % nb
	d = torch.arange(nb, dtype=torch.int64, device=device)
	return torch.unique(torch.cat([r * nb + c, c * nb + r, d * (nb + 1)]))


def draw(params: dict, keys: torch.Tensor) -> torch.Tensor:
	"""The tiles ``T`` of the blocks ``keys`` (``I·nb + J``), float32 ``(len(keys), bs, bs)``, on
	the keys' device."""
	_, bs, _ = dims(params)
	e = torch.arange(2 * bs * bs, dtype=torch.int64, device=keys.device)
	out = torch.empty((keys.shape[0], bs, bs), dtype=torch.float32, device=keys.device)
	step = max(1, CHUNK // e.shape[0])
	base = _key(params, TILES)
	for s in range(0, keys.shape[0], step):
		p = keys[s : s + step]
		t = _hash(base, p >> 32, p & M32)
		u = (_hash(t[:, None], e[None, :]).double() + 0.5) * 2.0**-32
		u1, u2 = u[:, : bs * bs], u[:, bs * bs :]
		z = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos((2.0 * math.pi) * u2)
		out[s : s + step] = z.view(-1, bs, bs)
	return out


_LAW = {}


def law(params: dict, device) -> tuple:
	"""``(I, J, A, rowabs)`` in float64 on ``device``: each block's row and column, its tile of the
	symmetric part ``A_IJ = (T_IJ + T_JIᵀ)/2`` (``T_JI`` drawn again by its own key), and
	``Σ_j |A_ij|`` by row ``(nb, bs)``. The last one asked for is kept, since a sweep applies the
	operator step after step."""
	tag = (json.dumps(params, sort_keys=True), str(torch.device(device)))
	if tag not in _LAW:
		_LAW.clear()
		_, bs, nb = dims(params)
		keys = pattern(params, device)
		I, J = keys // nb, keys % nb
		A = draw(params, keys).double()
		A.add_(draw(params, J * nb + I).double().transpose(1, 2)).mul_(0.5)
		rowabs = torch.zeros((nb, bs), dtype=torch.float64, device=keys.device).index_add_(0, I, A.abs().sum(dim=2))
		_LAW[tag] = (I, J, A, rowabs)
	return _LAW[tag]


def apply(params: dict, X: torch.Tensor, rnd=lambda x: x) -> torch.Tensor:
	"""``A X`` on a probe-major ``(nv, n)`` block, the off-diagonal part tile by tile in chunks."""
	_, bs, nb = dims(params)
	I, J, A, rowabs = law(params, X.device)
	nv = X.shape[0]
	Y = rnd(rowabs + 1.0).to(X.dtype).reshape(-1) * X
	X3, Y3 = X.reshape(nv, nb, bs), Y.view(nv, nb, bs)
	step = max(1, 2**30 // (nv * bs * X.element_size()))
	for s in range(0, I.shape[0], step):
		At = rnd(A[s : s + step]).to(X.dtype)
		Y3.index_add_(1, I[s : s + step], torch.einsum("tab,vtb->vta", At, X3[:, J[s : s + step]]))
	return Y


def interval(params: dict) -> tuple:
	"""The Gershgorin enclosure, worked out on the CPU: row ``i`` is centred on ``a_ii + Σ_j |A_ij| + 1``
	with radius ``Σ_{j≠i} |A_ij|``, so the lower end is at least 1."""
	I, J, A, rowabs = law(params, "cpu")
	a = A[I == J].diagonal(dim1=1, dim2=2)
	off = rowabs - a.abs()
	return float((a + rowabs + 1.0 - off).min()), float((a + rowabs + 1.0 + off).max())
