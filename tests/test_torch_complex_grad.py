"""Reverse mode on Hermitian (complex) operators: the port against ``jax.grad`` of the JAX package.

``differentiable=True`` on ``hutch`` (a plain operator), ``hutchpp``, ``xnystrace``, ``xtrace``,
``xdiag``, ``kpm_trace`` and ``block_slq_trace``, on a Hermitian dense, DIA, BSR (8×8 tiles, a
grid that overhangs n) and CSR operator, complex128. Each entry point draws the JAX package's
probes, regenerated from its keys and handed in through the port's samplers. The value must
equal JAX's within 1e-8 (relative), the gradient to the operator's data ``conj(jax.grad)`` within
1e-7 of its largest entry: PyTorch hands back ``∂L/∂conj(z)``, JAX its conjugate
(``jax.grad(|z|²)(1+1j) = 2−2j``, torch ``2+2j``).

Also: ``torch.autograd.gradcheck`` of the three kernel Functions on complex128 inputs (both DIA
layouts), lazy conjugate views handed to the wrappers, and JAX's refusals (``spectral_sum``,
reverse mode through Lanczos, ``diag``, ``cg``) raising in the port too.
"""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import jax
import jax.numpy as jnp

import primate_tpu as pt
from primate_tpu.operators.sparse import BSROperator as JaxBSR
from primate_tpu.operators.sparse import CSROperator as JaxCSR
from primate_tpu.operators.sparse import DIAOperator as JaxDIA
from primate_tpu.random import as_key
from primate_tpu.random import sample_isotropic as jax_sample

import primate_tpu_torch as ptt
from primate_tpu_torch import BSROperator, CSROperator, DIAOperator, MatrixFunction, block_krylov, diagonal, kpm, trace
from primate_tpu_torch.operators.base import DenseOperator
from primate_tpu_torch.ops import autograd as kad
from primate_tpu_torch.ops import bsr, dia

torch.set_num_threads(1)
SEED = 5
VAL_RTOL, GRAD_RTOL = 1e-8, 1e-7
N = 44
OFFSETS = (-9, -4, -1, 0, 1, 4, 9)
TILE = (8, 8)


def _hermitian_banded(n=N, seed=3):
	"""A Hermitian positive definite banded matrix with complex off-diagonal bands (scipy CSR)."""
	rng = np.random.default_rng(seed)
	B = sps.diags(
		[rng.normal(size=n - o) + 1j * rng.normal(size=n - o) for o in OFFSETS if o > 0], [o for o in OFFSETS if o > 0], shape=(n, n)
	)
	H = B + B.getH()
	shift = np.abs(H).sum(axis=1).A.ravel() + rng.uniform(0.5, 1.5, n)
	return (H + sps.diags(shift)).tocsr()


def _case(kind, real=False):
	"""(port operator, its data tensor, JAX operator of a jnp leaf, the leaf's numpy value); with
	``real`` the real symmetric part of the same matrix."""
	H = _hermitian_banded()
	if real:
		H = H.real.tocsr()
	if kind == "dense":
		A = H.toarray()
		t = torch.tensor(A, requires_grad=True)
		return DenseOperator(t), t, lambda leaf: leaf, A
	if kind == "dia":
		bands = DIAOperator.from_scipy(H, device="cpu").bands.numpy()
		offsets = DIAOperator.from_scipy(H, device="cpu").offsets
		t = torch.tensor(bands, requires_grad=True)
		return DIAOperator(t, offsets, H.shape), t, lambda leaf: JaxDIA(leaf, offsets, H.shape), bands
	if kind == "bsr":
		bm, bn = TILE
		S = H.copy()
		S.resize((-(-N // bm) * bm, -(-N // bn) * bn))
		S = S.tobsr(blocksize=TILE)
		t = torch.tensor(S.data, requires_grad=True)
		return (
			BSROperator(t, S.indices, S.indptr, H.shape), t,
			lambda leaf: JaxBSR(leaf, jnp.asarray(S.indices), jnp.asarray(S.indptr), H.shape), S.data,
		)
	H.sort_indices()
	t = torch.tensor(H.data, requires_grad=True)
	return CSROperator(t, H.indices, H.indptr, H.shape), t, lambda leaf: JaxCSR(leaf, H.indices, H.indptr, H.shape), H.data


def _jax_block(key, shape, pdf):
	"""JAX's probe block for a Hermitian operator: phase probes complex, the others real."""
	dt = jnp.complex128 if pdf == "phase" else jnp.float64
	return torch.from_numpy(np.array(jax_sample(key, shape, pdf=pdf, dtype=dt)).astype(np.complex128))


def _inject(monkeypatch, draw):
	"""Make the sketch estimators draw ``draw(it, k)`` (JAX's blocks) in place of their own."""
	sampler = lambda op, base, pdf: draw  # noqa: E731
	monkeypatch.setattr(trace, "probe_sampler", sampler)
	monkeypatch.setattr(diagonal, "probe_sampler", sampler)


def _inject_chunks(monkeypatch, module, block):
	"""Make ``module``'s draws ``sample_isotropic(batch_generator(base, i, ·), shape, ...)`` return
	``block(i, shape)``: the chunked draws of ``hutch`` and ``block_slq_trace``."""
	monkeypatch.setattr(trace, "batch_generator", lambda base, i, device: i)
	monkeypatch.setattr(module, "sample_isotropic", lambda i, shape, pdf, dtype: block(i, shape).to(dtype) if not dtype.is_complex
		else block(i, shape))


def _run(name, pdf, op, jax_op, monkeypatch):
	"""(port estimate, JAX loss of a leaf): the same estimator on the same probes."""
	key = as_key(SEED)
	w = np.random.default_rng(1).normal(size=N)
	if name == "hutch":
		batch, count = 4, 12
		_inject_chunks(monkeypatch, trace, lambda i, shape: torch.real(_jax_block(jax.random.fold_in(key, i), shape, pdf)))
		got = ptt.hutch(op, batch=batch, pdf=pdf, converge="count", count=count, seed=SEED, differentiable=True)
		return got, lambda x: pt.hutch(jax_op(x), batch=batch, pdf=pdf, converge="count", count=count, seed=SEED, differentiable=True)
	if name == "hutchpp":
		k1, k2 = jax.random.split(key)
		_inject(monkeypatch, lambda it, k: _jax_block((k1, k2)[it], (N, k), pdf))
		got = ptt.hutchpp(op, m=9, pdf=pdf, seed=SEED, differentiable=True)
		return got, lambda x: pt.hutchpp(jax_op(x), m=9, pdf=pdf, seed=SEED, differentiable=True)
	if name == "xnystrace":
		_inject(monkeypatch, lambda it, k: _jax_block(key, (N, k), pdf))
		got = ptt.xnystrace(op, m=12, pdf=pdf, seed=SEED, differentiable=True)
		return got, lambda x: pt.xnystrace(jax_op(x), m=12, pdf=pdf, seed=SEED, differentiable=True)
	if name == "xtrace":
		_inject(monkeypatch, lambda it, k: _jax_block(jax.random.fold_in(key, it), (N, k), pdf))
		got = ptt.xtrace(op, batch=8, pdf=pdf, converge="count", count=24, seed=SEED, differentiable=True)
		return got, lambda x: pt.xtrace(jax_op(x), batch=8, pdf=pdf, converge="count", count=24, seed=SEED, differentiable=True)
	if name == "xdiag":
		_inject(monkeypatch, lambda it, k: _jax_block(key, (N, k), pdf))
		got = ptt.xdiag(op, m=20, pdf=pdf, seed=SEED, differentiable=True) @ torch.from_numpy(w)
		return got, lambda x: pt.xdiag(jax_op(x), m=20, pdf=pdf, seed=SEED, differentiable=True) @ jnp.asarray(w)
	if name == "kpm_trace":
		hi = 1.05 * float(np.linalg.eigvalsh(_hermitian_banded().toarray())[-1])
		kw = dict(m=10, nv=6, pdf=pdf, interval=(0.0, hi), seed=SEED, differentiable=True)
		block = lambda op, nv, pdf, seed: _jax_block(key, (N, nv), pdf).to(op.dtype) if op.dtype.is_complex else torch.real(  # noqa: E731
			_jax_block(key, (N, nv), pdf))
		monkeypatch.setattr(kpm, "_probes", block)
		return ptt.kpm_trace(op, "exp", **kw, t=-0.1), lambda x: pt.kpm_trace(jax_op(x), "exp", **kw, t=-0.1)
	keys = jax.random.split(key, 2)
	_inject_chunks(monkeypatch, block_krylov, lambda i, shape: torch.real(_jax_block(keys[i], shape, pdf)))
	kw = dict(b=4, deg=3, nblocks=2, pdf=pdf, seed=SEED, differentiable=True)
	return ptt.block_slq_trace(op, "log", **kw, device="cpu"), lambda x: pt.block_slq_trace(jax_op(x), "log", **kw)


def _close(got, want, rtol):
	got, want = np.asarray(got), np.asarray(want)
	assert np.max(np.abs(got - want)) <= rtol * max(np.max(np.abs(want)), 1e-300), np.max(np.abs(got - want))


ESTIMATORS = [
	("hutch", "rademacher"), ("hutchpp", "rademacher"), ("hutchpp", "phase"), ("xnystrace", "normal"), ("xnystrace", "phase"),
	("xtrace", "sphere"), ("xtrace", "phase"), ("xdiag", "sphere"), ("kpm_trace", "rademacher"), ("kpm_trace", "phase"),
	("block_slq_trace", "normal"),
]


@pytest.mark.parametrize("kind", ["dense", "dia", "bsr", "csr"])
@pytest.mark.parametrize("name,pdf", ESTIMATORS, ids=["-".join(c) for c in ESTIMATORS])
def test_hermitian_reverse_mode_matches_jax(name, pdf, kind, monkeypatch):
	"""Value (real, JAX's dtype) and gradient to the operator's data, ``conj(jax.grad)``."""
	op, t, jax_op, leaf = _case(kind)
	got, ref = _run(name, pdf, op, jax_op, monkeypatch)
	assert isinstance(got, torch.Tensor) and got.requires_grad and got.shape == ()
	(g,) = torch.autograd.grad(got, t)
	want, jg = jax.value_and_grad(ref)(jnp.asarray(leaf))
	assert got.dtype == torch.float64 and np.dtype(want.dtype) == np.float64
	_close(got.detach(), want, VAL_RTOL)
	assert g.dtype == torch.complex128 and g.shape == t.shape
	_close(g, np.conj(np.asarray(jg)), GRAD_RTOL)


@pytest.mark.parametrize("kind", ["dense", "dia", "bsr", "csr"])
@pytest.mark.parametrize("name,pdf", [("kpm_trace", "rademacher"), ("block_slq_trace", "normal")], ids=["kpm_trace", "block_slq_trace"])
def test_real_reverse_mode_of_kpm_and_block_slq_matches_jax(name, pdf, kind, monkeypatch):
	"""Two faults that real operators shared: the KPM recurrence finished each step in place on the
	apply's output, which a BSR operator's ``matmat_t`` hands back as a view of its Function's output
	(autograd refuses that), and block Lanczos wrote each new block into the basis that its CGS
	passes had saved for the backward (``deg > 1``). Both are held to ``jax.grad`` here."""
	op, t, jax_op, leaf = _case(kind, real=True)
	got, ref = _run(name, pdf, op, jax_op, monkeypatch)
	(g,) = torch.autograd.grad(got, t)
	want, jg = jax.value_and_grad(ref)(jnp.asarray(leaf))
	_close(got.detach(), want, VAL_RTOL)
	assert g.dtype == torch.float64
	_close(g, jg, GRAD_RTOL)


def test_complex64_block_quadrature_gradient_at_a_large_scale():
	"""A fault found on the card: block SLQ's ``eigh`` backward refused a complex64 gradient whose
	entries are large (PyTorch checks the eigenvector phase to an absolute 1e-2, which rounding
	trips). The quadrature now differentiates ``f(T)`` by the Daleckii-Krein formula: the gradient
	of ``tr(VᴴH²V)/b`` (exact at 2 block steps) meets Euler's identity at degree 2."""
	n = 400
	rng = np.random.default_rng(0)
	X = rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n))
	A = torch.tensor(15 * (X + X.conj().T), dtype=torch.complex64, requires_grad=True)
	est = ptt.block_slq_trace(DenseOperator(A), lambda x: x**2, b=8, deg=2, nblocks=1, seed=1, differentiable=True, device="cpu")
	(g,) = torch.autograd.grad(est, A)
	assert est.item() > 1e8
	lhs = torch.sum(torch.real(g.conj().to(torch.complex128) * A.detach().to(torch.complex128))).item()
	assert lhs == pytest.approx(2 * est.item(), rel=1e-5)


def test_hutch_gradient_of_the_trace_is_the_probe_identity():
	"""``hutch``'s estimate is linear in the operator: its gradient to a dense Hermitian ``A`` is
	the mean of ``v vᴴ`` over the probes (PyTorch's convention), and Euler's identity
	``Σ Re(conj(g)·A) = estimate`` holds to rounding."""
	op, t, _, A = _case("dense")
	est = ptt.hutch(op, batch=8, pdf="phase", converge="count", count=16, seed=2, differentiable=True)
	(g,) = torch.autograd.grad(est, t)
	assert float(torch.sum(torch.real(g.conj() * t.detach()))) == pytest.approx(est.item(), rel=1e-12)
	assert float(torch.real(torch.trace(g))) == pytest.approx(N, rel=1e-12)  # tr(E[vvᴴ]) = ‖v‖² = N for phase probes


# --- the kernel Functions ----------------------------------------------------------------------


def _cplx(rng, shape):
	return torch.tensor(rng.normal(size=shape) + 1j * rng.normal(size=shape), requires_grad=True)


@pytest.mark.parametrize("fn", ["dia_stencil_t", "dia_stencil", "bsr_spmm", "csr_spmm"])
def test_functions_pass_gradcheck_on_complex128(fn):
	"""``torch.autograd.gradcheck`` (Wirtinger) of each Function's backward: the adjoint apply on the
	conjugated adjoint bands or tiles, and the conjugated parameter reductions."""
	rng = np.random.default_rng(7)
	n, k = 29, 3
	if fn.startswith("dia"):
		offs = (-6, -1, 0, 2, 11)
		ot = torch.tensor(offs)
		bands = _cplx(rng, (len(offs), n))
		if fn == "dia_stencil_t":
			args, f = (bands, _cplx(rng, (k, n))), lambda b, x: kad.dia_stencil_t_ad(b, x, ot, offs)
		else:
			args, f = (bands, _cplx(rng, (n, k))), lambda b, x: kad.dia_stencil_ad(b, x, ot, offs)
	else:
		M = sps.random(n, n, density=0.15, random_state=3, format="csr")
		M = sps.csr_matrix((M.data + 1j * rng.normal(size=M.nnz), M.indices, M.indptr), shape=M.shape)
		V = _cplx(rng, (n, k))
		if fn == "bsr_spmm":
			M.resize((32, 32))
			S = M.tobsr(blocksize=(4, 8))
			ip, ix = torch.tensor(S.indptr), torch.tensor(S.indices)
			args, f = (torch.tensor(S.data, requires_grad=True), V), lambda b, v: kad.bsr_spmm_ad(b, v, ip, ix, n)
		else:
			data = torch.tensor(M.data, requires_grad=True)
			op = CSROperator(data, M.indices, M.indptr, M.shape)
			args, f = (data, V), lambda d, v: kad.csr_spmm_ad(d, v, op)
	assert torch.autograd.gradcheck(f, args)


@pytest.mark.parametrize("layout", ["probe_major", "node_major"])
def test_dia_backward_is_the_conjugate_transpose(layout):
	"""The input gradient is ``Aᴴ·G`` and the band gradient ``Σ_b G·conj(x)``, against the dense
	matrix, with ``G`` handed in as a lazy conjugate view."""
	rng = np.random.default_rng(11)
	n, k, offs = 31, 4, (-3, 0, 5)
	bands = _cplx(rng, (3, n))
	A = DIAOperator(bands.detach(), offs, (n, n)).todense().numpy()
	pm = layout == "probe_major"
	x = _cplx(rng, (k, n) if pm else (n, k))
	G0 = torch.tensor(rng.normal(size=x.shape) + 1j * rng.normal(size=x.shape))
	f = kad.dia_stencil_t_ad if pm else kad.dia_stencil_ad
	out = f(bands, x, torch.tensor(offs), offs)
	gb, gx = torch.autograd.grad(out, (bands, x), G0.conj().conj())
	Gd, xd = (G0.numpy().T, x.detach().numpy().T) if pm else (G0.numpy(), x.detach().numpy())
	np.testing.assert_allclose(gx.numpy(), (A.conj().T @ Gd).T if pm else A.conj().T @ Gd, rtol=0, atol=1e-12)
	for d, off in enumerate(offs):
		r = np.arange(max(0, -off), min(n, n - off))
		np.testing.assert_allclose(gb[d, r].numpy(), np.sum(Gd[r] * xd[r + off].conj(), axis=1), rtol=0, atol=1e-12)


@pytest.mark.parametrize("wrapper", ["dia_stencil_t", "dia_stencil", "bsr_spmm"])
def test_wrappers_take_conjugate_views(wrapper):
	"""A lazy ``x.conj()`` (and conjugated bands or tiles) gives the result of its written-out copy."""
	rng = np.random.default_rng(13)
	n, k = 40, 3
	if wrapper == "bsr_spmm":
		S = sps.random(n, n, density=0.2, random_state=4, format="csr")
		S = sps.csr_matrix((S.data + 1j * rng.normal(size=S.nnz), S.indices, S.indptr), shape=S.shape).tobsr(blocksize=(8, 8))
		blocks = torch.tensor(S.data)
		V = torch.tensor(rng.normal(size=(n, k)) + 1j * rng.normal(size=(n, k)))
		call = lambda b, v: bsr.bsr_spmm(b, torch.tensor(S.indptr), torch.tensor(S.indices), v, n)  # noqa: E731
	else:
		blocks = torch.tensor(rng.normal(size=(3, n)) + 1j * rng.normal(size=(3, n)))
		shape = (k, n) if wrapper == "dia_stencil_t" else (n, k)
		V = torch.tensor(rng.normal(size=shape) + 1j * rng.normal(size=shape))
		fn = getattr(dia, wrapper)
		call = lambda b, v: fn(b, torch.tensor([-2, 0, 3]), v)  # noqa: E731
	assert V.conj().is_conj()
	torch.testing.assert_close(call(blocks.conj(), V.conj()), call(blocks.conj().resolve_conj(), V.conj().resolve_conj()), rtol=0, atol=0)


def test_check_cuda_refuses_lazy_views():
	"""A kernel reads bytes: ``check_cuda`` refuses a lazy conjugate or negative view before any
	other check of a tensor, so no launch reads a conjugated tensor unconjugated (checked without a
	card on CPU views); :func:`resolved` writes such a view out."""
	from primate_tpu_torch.ops._common import check_cuda, resolved

	x = torch.ones(4, dtype=torch.complex64)
	assert resolved(x) is x and not resolved(x.conj()).is_conj() and not resolved(x.conj().imag).is_neg()
	dev = torch.device("cuda", 0)
	for view in (x.conj(), x.conj().imag):
		with pytest.raises(ValueError, match="lazy conjugate"):
			check_cuda("dia_stencil_t", view.dtype, dev, complex_ok=True, x=view)


# --- what JAX refuses -------------------------------------------------------------------------


def _herm_dense():
	return torch.from_numpy(np.array(pt.hermitian(8, ew=np.linspace(0.5, 1.5, 8), seed=1)))


@pytest.mark.parametrize("branch", ["spectral_sum", "lanczos", "diag", "cg"])
def test_jax_refusals_still_raise(branch):
	"""``spectral_sum`` (``hutch`` on a ``MatrixFunction``), reverse mode through Lanczos, ``diag``
	and ``cg`` refuse a Hermitian operator's gradient, as the JAX package does."""
	A = _herm_dense().requires_grad_(True)
	op = DenseOperator(A)
	calls = {
		"spectral_sum": lambda: ptt.hutch(MatrixFunction(op, "log", deg=4, orth=4), converge="count", count=4,
			differentiable=True).backward(),
		"lanczos": lambda: MatrixFunction(op, "log", deg=4, orth=0).quad(torch.ones((8, 2), dtype=torch.complex128)),
		"diag": lambda: ptt.diag(op, converge="count", count=2, differentiable=True),
		"cg": lambda: ptt.cg(op, torch.ones(8, dtype=torch.complex128)),
	}
	with pytest.raises(NotImplementedError):
		calls[branch]()
	if branch in ("spectral_sum", "diag"):
		Aj = jnp.asarray(A.detach().numpy())
		jcall = {
			"spectral_sum": lambda x: pt.hutch(pt.MatrixFunction(x, "log", deg=4, orth=4), converge="count", count=4, differentiable=True),
			"diag": lambda x: jnp.sum(pt.diag(x, converge="count", count=2, differentiable=True)),
		}[branch]
		with pytest.raises(NotImplementedError):
			jax.grad(jcall)(Aj) if branch == "spectral_sum" else jcall(Aj)
