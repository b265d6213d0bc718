"""Faults planted under the program's timed path: a step that returns its state unchanged, half of
the batch left out with the mean taken over the rest, and the answer moved where it is produced.
The tests plant each at a small size and see a run read ``correct`` false;
``python3 -m port_bench.readings --side <fault>`` reads each at a cell's own size.

A planter takes ``patch(owner, name, value)``, a ``setattr`` that the caller undoes (pytest's
``monkeypatch.setattr``) or leaves (a process that ends after its readings). Each call module names
the faults its cells can have in ``faults(traffic, limit)``.
"""


def _step_owners() -> tuple:
	"""The classes whose Lanczos steps an operator of any format runs: DIA's own (the step kernels),
	and the base class's, which BSR and CSR operators take."""
	from primate_tpu_torch.operators.base import LinearOperator
	from primate_tpu_torch.operators.sparse import DIAOperator

	return DIAOperator, LinearOperator


def unchanged_sweep_step(patch) -> None:
	"""The Lanczos sweep's step (passes A and B on a DIA operator) hands back its input vector."""
	for owner in _step_owners():
		real = owner.lanczos_sweep_step

		def step(self, v_cur, v_prev, state, alpha_out, beta_out, tol, layout=None, _real=real, **kw):
			_real(self, v_cur, v_prev, state, alpha_out, beta_out, tol, **({"layout": layout} if layout else {}), **kw)
			return v_cur

		patch(owner, "lanczos_sweep_step", step)


def unchanged_window_step(patch) -> None:
	"""The re-orthogonalised Lanczos step hands back its input vector."""
	for owner in _step_owners():
		real = owner.lanczos_step

		def step(self, q_cur, q_prev, beta, *a, _real=real, **kw):
			v, alpha = _real(self, q_cur, q_prev, beta, *a, **kw)
			return q_cur.to(v.dtype).clone(), alpha

		patch(owner, "lanczos_step", step)


def unchanged_chebyshev_step(patch) -> None:
	"""The Chebyshev recurrence's step hands back its last term."""
	from primate_tpu_torch import kpm

	patch(kpm, "_next_term", lambda op, Tm, Tm1, c, r, *keep: Tm.clone())


def half_hutch_batch(patch) -> None:
	"""The quadratic forms of the first half of each batch, repeated for the second half."""
	import torch

	from primate_tpu_torch import trace

	real = trace.quad_form

	def quad(op, V):
		s = real(op, V[:, : V.shape[1] // 2])
		return torch.cat([s, s], dim=-1)

	patch(trace, "quad_form", quad)


def half_kpm_batch(patch) -> None:
	"""The Chebyshev moments of the first half of the probes, repeated for the second half."""
	import torch

	from primate_tpu_torch import kpm

	real = kpm._moment_scan

	def scan(op, Vt, m, c, r):
		mu = real(op, Vt[: Vt.shape[0] // 2], m, c, r)
		return torch.cat([mu, mu], dim=1)

	patch(kpm, "_moment_scan", scan)


def half_density_batch(patch) -> None:
	"""The Lanczos coefficients of the first half of the probes, repeated for the second half."""
	import torch

	from primate_tpu_torch import density

	real = density.lanczos_block_op

	def sweep(op, V, **kw):
		out = real(op, V[:, : V.shape[1] // 2], **kw)
		return out._replace(alphas=torch.cat([out.alphas] * 2, dim=1), betas=torch.cat([out.betas] * 2, dim=1))

	patch(density, "lanczos_block_op", sweep)


def altered_answer(entry: str, by: float):
	"""The entry point ``entry`` of the program moves its answer by ``by``: a scalar by that share of
	itself, a density at one grid point by that share of its largest value."""

	def plant(patch) -> None:
		import primate_tpu_torch as ptt

		real = getattr(ptt, entry)

		def call(*a, **kw):
			out = real(*a, **kw)
			if isinstance(out, float):
				return out * (1.0 + by)
			ts, phi = out
			phi = phi.copy()
			phi[len(phi) // 3] += by * abs(phi).max()
			return ts, phi

		patch(ptt, entry, call)

	return plant
