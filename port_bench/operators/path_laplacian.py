"""``tridiag(o, d, o)`` as three bands."""

import torch


def bands(params: dict, dtype: torch.dtype, device) -> tuple:
	n, d, o = int(params["n"]), float(params["diagonal"]), float(params["off_diagonal"])
	b = torch.empty((3, n), dtype=dtype, device=device)
	b[0].fill_(o)
	b[0, 0] = 0
	b[1].fill_(d)
	b[2].fill_(o)
	b[2, -1] = 0
	return b, (-1, 0, 1), (n, n)
