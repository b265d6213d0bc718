"""The probes of a call, drawn again from its seed.

The program documents its draw: batch ``it`` of a call with seed ``s`` comes from a
``torch.Generator`` on the probes' device seeded with ``SeedSequence([s, it])``'s first
64-bit word shifted right by one; Rademacher signs are ``randint(0, 2)·2 − 1`` in the real
dtype, unit phases ``e^{iθ}`` with ``θ = 2π·rand`` in the real dtype, both drawn probe-major
``(nv, n)``. The same calls on the same device give the same bits, so the reference sees the
probes the program saw without taking them from it.
"""

import math

import numpy as np
import torch


def sub_seed(seed: int, it: int) -> int:
	return int(np.random.SeedSequence([seed, it]).generate_state(1, np.uint64)[0] >> np.uint64(1))


def draw(seed: int, it: int, n: int, nv: int, pdf: str, dtype: torch.dtype, device) -> torch.Tensor:
	"""Batch ``it`` of the call seeded ``seed``: ``(nv, n)`` in ``dtype``, the program's probe dtype
	(complex for ``pdf="phase"``, else the operator's real dtype)."""
	g = torch.Generator(device=device)
	g.manual_seed(sub_seed(seed, it))
	real = dtype.to_real() if dtype.is_complex else dtype
	if pdf == "phase":
		theta = torch.rand((nv, n), generator=g, device=device, dtype=real).mul_(2.0 * math.pi)
		return torch.polar(torch.ones_like(theta), theta)
	if pdf == "rademacher":
		return torch.randint(0, 2, (nv, n), generator=g, device=device, dtype=real).mul_(2).sub_(1)
	raise ValueError(f"no reference draw for pdf {pdf!r}")
