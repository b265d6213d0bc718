"""Plain references of the benchmark's cells: PyTorch and NumPy only.

Nothing here imports the program (``primate_tpu_torch``), the JAX package or JAX. Each
reference works its operator out again from the configuration's parameters (never from the
bands handed to the program) and its probes from the call's seed, and computes in a stated
precision: ``"float64"`` for the check, ``"bfloat16"`` for the lower-precision control
(vectors and coefficients rounded to bfloat16 wherever they are stored, arithmetic in float32).
"""

import importlib
from types import SimpleNamespace

import torch

# The reference works on blocks of probes of at most this many bytes a vector, so that a step's
# handful of vectors and temporaries fits beside nothing else on the card.
BLOCK_BYTES = 2**31


def _bf16(x: torch.Tensor) -> torch.Tensor:
	if x.is_complex():
		return torch.complex(x.real.to(torch.bfloat16).float(), x.imag.to(torch.bfloat16).float())
	return x.to(torch.bfloat16).float()


def operator(cfg: dict, precision: str, device) -> SimpleNamespace:
	"""The configuration's operator as the reference applies it: ``apply(X)`` on a probe-major
	``(nv, n)`` block in the work dtype, ``interval()`` its Gershgorin enclosure, ``rnd`` the
	rounding of a stored vector, ``probe_dtype(pdf)`` the dtype the program draws its probes in,
	``block`` the probes a reference block holds."""
	mod = importlib.import_module(f"{__name__}.{cfg['operator']}")
	dtype = getattr(torch, cfg["dtype"])
	if precision == "float64":
		work, rnd = (torch.complex128 if dtype.is_complex else torch.float64), (lambda x: x)
	elif precision == "bfloat16":
		work, rnd = (torch.complex64 if dtype.is_complex else torch.float32), _bf16
	else:
		raise ValueError(f"no reference precision {precision!r}")
	params, n = cfg["params"], mod.size(cfg["params"])
	return SimpleNamespace(
		n=n, device=torch.device(device), work=work, rnd=rnd,
		apply=lambda X: mod.apply(params, X, rnd),
		interval=lambda: mod.interval(params),
		probe_dtype=lambda pdf: dtype if pdf == "phase" else (dtype.to_real() if dtype.is_complex else dtype),
		block=max(1, BLOCK_BYTES // (n * work.itemsize)),
	)
