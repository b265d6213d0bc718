"""The eigensolvers of the port against the JAX package, float64, on numpy inputs made from
a seed: LOBPCG on an injected start block against ``jax.experimental.sparse.linalg.lobpcg_standard``
(θ to 1e-10, vectors up to sign to 1e-8), thick-restart Lanczos on an injected start
vector, and ``filtered_eigsh``, ``rsvd`` and ``rand_nystrom`` on the JAX package's sketches
(1e-10); ``eigsh`` and ``svds`` end to end at the reference tests' bars (``tests/test_eigen.py``),
complex Hermitian operators through the real image included."""

import warnings

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import jax
import jax.numpy as jnp
from jax.experimental import sparse as jsparse
from jax.experimental.sparse.linalg import lobpcg_standard

import primate_tpu as pt
from primate_tpu import eigen as jax_eigen
from primate_tpu.operators.sparse import DIAOperator as JaxDIA
from primate_tpu.random import as_key

import primate_tpu_torch as ptt
from primate_tpu_torch import eigen

torch.set_num_threads(1)


def _np(x):
	return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, rtol=1e-10, atol=1e-12):
	np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol)


def _close_up_to_sign(got, want, atol=1e-8):
	got, want = _np(got), _np(want)
	phase = np.sum(np.conj(got) * want, axis=0)
	phase = phase / np.abs(phase)
	np.testing.assert_allclose(got * phase[None, :], want, rtol=0, atol=atol)


def _fixture(n=64, lo=0.5, hi=3.0, seed=1):
	ew = np.linspace(lo, hi, n)
	return np.array(pt.symmetric(n, pd=True, ew=ew, seed=seed)), ew


def _separated(n=200, seed=3):
	ew = np.concatenate([np.linspace(0.1, 1.0, n - 5), [2.0, 2.5, 3.0, 3.6, 4.2]])
	return np.array(pt.symmetric(n, ew=ew, seed=seed)), ew


def _grid(nx, ny):
	ex, ey = np.ones(nx), np.ones(ny)
	Tx = sps.diags([-ex[:-1], 2 * ex, -ex[:-1]], [-1, 0, 1])
	Ty = sps.diags([-ey[:-1], 2 * ey, -ey[:-1]], [-1, 0, 1])
	L = (sps.kron(sps.identity(ny), Tx) + sps.kron(Ty, sps.identity(nx))).tocsr()
	jx, jy = np.arange(1, nx + 1), np.arange(1, ny + 1)
	lam = (4 * np.sin(jx * np.pi / (2 * (nx + 1))) ** 2)[:, None] + (4 * np.sin(jy * np.pi / (2 * (ny + 1))) ** 2)[None, :]
	return L, np.sort(lam.ravel())


# --- the two iterations against JAX on injected starts ---


@pytest.mark.parametrize("m", [1, 3, 40])
@pytest.mark.parametrize("k", [1, 4])
def test_lobpcg_matches_jax_on_an_injected_block(m, k):
	A, ew = _separated()
	X0 = np.random.default_rng(k).standard_normal((A.shape[0], k))
	th, U, it = lobpcg_standard(lambda X: jnp.asarray(A) @ X, jnp.asarray(X0), m=m)
	At = torch.from_numpy(A)
	th2, U2, it2 = eigen._lobpcg_standard(lambda X: At @ X, torch.from_numpy(X0), m=m)
	assert it2 == int(it)
	_close(th2, th, rtol=1e-10, atol=1e-12)
	_close_up_to_sign(U2, U, atol=1e-8)
	if m == 40:
		_close(th2, ew[::-1][:k], rtol=1e-10)


def test_lobpcg_follows_jax_on_a_clustered_grid():
	# The 100 × 100 grid's top eigenvalues are clustered (steps of about 1e-3, some repeated), so
	# 100 iterations from one start block do not resolve them: the port ends where JAX's
	# lobpcg_standard ends, θ for θ.
	L, lam = _grid(100, 100)
	X0 = np.random.default_rng(0).standard_normal((L.shape[0], 10))
	Lj = jsparse.BCOO.from_scipy_sparse(L.tocoo())
	th, _, it = lobpcg_standard(lambda X: Lj @ X, jnp.asarray(X0), m=100, tol=1e-12)
	op = ptt.DIAOperator.from_scipy(L, device="cpu")
	th2, _, it2 = eigen._lobpcg_standard(op.matmat, torch.from_numpy(X0), m=100, tol=1e-12)
	assert it2 == int(it) == 100
	_close(th2, th, rtol=1e-10)
	assert np.all(_np(th2) <= lam[::-1][:10] + 1e-12)  # Ritz values interlace from below


def test_lobpcg_refuses_a_wide_block():
	with pytest.raises(ValueError):
		eigen._lobpcg_standard(lambda X: X, torch.zeros((20, 4), dtype=torch.float64))


@pytest.mark.parametrize("k", [2, 3])
def test_trlan_matches_jax_on_an_injected_start(k):
	A, ew = _separated(150)
	n = A.shape[0]
	key = jax.random.PRNGKey(5)
	_, k0 = jax.random.split(key)
	v0 = np.array(jax.random.normal(k0, (n,), jnp.float64))
	lam, V = jax_eigen._trlan_top(lambda X: jnp.asarray(A) @ X, n, k, jnp.float64, key, 200, None)
	At = torch.from_numpy(A)
	g = torch.Generator()
	g.manual_seed(0)
	lam2, V2 = eigen._trlan_top(lambda X: At @ X, lambda v: At @ v, n, k, torch.float64, g, 200, None, v0=torch.from_numpy(v0))
	_close(lam2, lam, rtol=1e-10)
	_close_up_to_sign(V2, V, atol=1e-8)
	_close(lam2, ew[::-1][:k], rtol=1e-10)


# --- eigsh end to end, at the reference tests' bars ---


@pytest.mark.parametrize("method", ["lobpcg", "trlan"])
@pytest.mark.parametrize("which", ["LA", "SA", "BE"])
def test_eigsh_ends(method, which):
	A, ew = _fixture()
	w, V = ptt.eigsh(torch.from_numpy(A), k=4, which=which, seed=0, method=method)
	want = {"LA": ew[-4:], "SA": ew[:4], "BE": np.concatenate([ew[:2], ew[-2:]])}[which]
	np.testing.assert_allclose(_np(w), want, atol=1e-4)
	V = _np(V)
	assert np.abs(A @ V - V * _np(w)[None, :]).max() < 1e-3
	np.testing.assert_allclose(V.T @ V, np.eye(4), atol=1e-6)


@pytest.mark.parametrize("method", ["lobpcg", "trlan"])
def test_eigsh_largest_magnitude_indefinite(method):
	ew = np.sort(np.concatenate([-np.linspace(2.5, 3.0, 3), np.linspace(0.2, 2.0, 61)]))
	B = np.array(pt.symmetric(64, ew=ew, seed=2))
	w = ptt.eigsh(torch.from_numpy(B), k=3, which="LM", seed=0, method=method, return_eigenvectors=False)
	np.testing.assert_allclose(np.sort(np.abs(_np(w))), np.sort(np.abs(ew))[-3:], atol=1e-3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("method", ["lobpcg", "trlan"])
def test_eigsh_on_a_dia_operator(method, dtype):
	n = 256
	L = sps.diags([-np.ones(n - 1), 3.0 * np.ones(n), -np.ones(n - 1)], [-1, 0, 1]).tocsr()
	op = ptt.DIAOperator.from_scipy(L, dtype=dtype, device="cpu")
	kk = np.arange(1, n + 1)
	ew = np.sort(3.0 - 2.0 * np.cos(kk * np.pi / (n + 1)))
	w = ptt.eigsh(op, k=3, which="LA", seed=0, method=method, return_eigenvectors=False)
	assert w.dtype == dtype
	np.testing.assert_allclose(_np(w), ew[-3:], atol=1e-6 if dtype == torch.float64 else 1e-4)
	assert eigen.ITERATIONS[method] > 0


def test_eigsh_dense_shortcut_and_validation():
	A, ew = _fixture(16)
	for which, want in (("LA", ew[-3:]), ("SA", ew[:3]), ("BE", np.concatenate([ew[:1], ew[-2:]]))):
		w, V = ptt.eigsh(torch.from_numpy(A), k=3, which=which)
		np.testing.assert_allclose(_np(w), want, atol=1e-10)
		np.testing.assert_allclose(A @ _np(V), _np(V) * _np(w)[None, :], atol=1e-10)
	with pytest.raises(ValueError):
		ptt.eigsh(torch.from_numpy(A), k=16)
	with pytest.raises(ValueError):
		ptt.eigsh(torch.from_numpy(A), k=2, which="XX")
	with pytest.raises(ValueError):
		ptt.eigsh(torch.from_numpy(A), k=2, method="arpack")


@pytest.mark.parametrize("method", ["lobpcg", "trlan"])
@pytest.mark.parametrize("which", ["LA", "SA", "BE"])
def test_eigsh_complex_hermitian(method, which):
	n = 60
	ew = np.linspace(0.5, 3.0, n)
	H = np.array(pt.hermitian(n, ew=ew, seed=3))
	w, V = ptt.eigsh(torch.from_numpy(H), k=4, which=which, seed=1, method=method)
	want = {"LA": ew[-4:], "SA": ew[:4], "BE": np.concatenate([ew[:2], ew[-2:]])}[which]
	np.testing.assert_allclose(_np(w), want, atol=1e-4)
	V = _np(V)
	assert V.dtype == np.complex128
	assert np.abs(H @ V - V * _np(w)[None, :]).max() < 1e-3


def test_eigsh_complex_degenerate_eigenvalue_returns_k():
	n = 60
	ew = np.concatenate([np.linspace(0.1, 1.0, n - 3), np.full(3, 2.0)])
	H = np.array(pt.hermitian(n, ew=ew, seed=4))
	w, V = ptt.eigsh(torch.from_numpy(H), k=3, which="LA", seed=0)
	np.testing.assert_allclose(_np(w), 2.0, atol=1e-5)
	V = _np(V)
	np.testing.assert_allclose(V.conj().T @ V, np.eye(3), atol=1e-5)


def test_eigsh_on_a_gram_operator_is_svds():
	rng = np.random.default_rng(11)
	X = rng.normal(size=(80, 40)) @ np.diag(np.linspace(0.1, 4.0, 40))
	w = ptt.eigsh(ptt.GramOperator(torch.from_numpy(X)), k=3, seed=0, return_eigenvectors=False)
	np.testing.assert_allclose(np.sqrt(_np(w)), np.sort(np.linalg.svd(X, compute_uv=False))[-3:], rtol=1e-6)


# --- svds ---


@pytest.mark.parametrize("shape", [(80, 40), (30, 90)])
def test_svds_matches_numpy(shape):
	rng = np.random.default_rng(12)
	X = rng.normal(size=shape) @ np.diag(np.linspace(0.1, 4.0, shape[1]))
	k = 5 if shape[0] > shape[1] else 3
	U, s, Vh = (_np(t) for t in ptt.svds(torch.from_numpy(X), k=k, seed=0))
	s_true = np.linalg.svd(X, compute_uv=False)
	np.testing.assert_allclose(np.sort(s), np.sort(s_true)[-k:], rtol=1e-5)
	np.testing.assert_allclose(X @ Vh.T, U * s[None, :], atol=1e-4)
	np.testing.assert_allclose(U.T @ U, np.eye(k), atol=1e-4)
	np.testing.assert_allclose(Vh @ Vh.T, np.eye(k), atol=1e-4)


def test_svds_values_only_and_validation():
	X = np.random.default_rng(13).normal(size=(50, 20))
	s = ptt.svds(torch.from_numpy(X), k=2, seed=2, return_vectors=False)
	assert tuple(s.shape) == (2,)
	with pytest.raises(ValueError):
		ptt.svds(torch.from_numpy(X), k=20)


# --- rsvd and rand_nystrom on the JAX package's sketches ---


def _inject(monkeypatch, sketch):
	monkeypatch.setattr(eigen, "_gaussian_sketch", lambda gen, shape, dtype: torch.tensor(np.asarray(sketch), dtype=dtype))


@pytest.mark.parametrize("n_iter", [0, 2])
def test_rsvd_matches_jax_on_its_sketch(monkeypatch, n_iter):
	rng = np.random.default_rng(0)
	m, n, k = 120, 80, 8
	sv = np.concatenate([np.linspace(10, 5, k), 1e-3 * rng.uniform(size=n - k)])
	U0, _ = np.linalg.qr(rng.normal(size=(m, n)))
	V0, _ = np.linalg.qr(rng.normal(size=(n, n)))
	X = (U0 * sv) @ V0.T
	U, s, Vh = pt.rsvd(X, k=k, n_iter=n_iter, seed=1)
	_inject(monkeypatch, jax_eigen._gaussian_sketch(as_key(1), (n, k + 8), jnp.float64))
	U2, s2, Vh2 = ptt.rsvd(torch.from_numpy(X), k=k, n_iter=n_iter, seed=1)
	_close(s2, s, rtol=1e-10)
	_close_up_to_sign(U2, U, atol=1e-8)
	_close_up_to_sign(_np(Vh2).T, np.asarray(Vh).T, atol=1e-8)
	assert np.abs(_np(s2) - sv[:k]).max() < 1e-5


def test_rsvd_complex_and_matrix_free():
	rng = np.random.default_rng(1)
	X = rng.standard_normal((60, 40)) + 1j * rng.standard_normal((60, 40))
	X = X @ np.diag(np.geomspace(10, 1e-3, 40))
	U, s, Vh = (_np(t) for t in ptt.rsvd(torch.from_numpy(X), k=4, n_iter=3, seed=2))
	np.testing.assert_allclose(s, np.linalg.svd(X, compute_uv=False)[:4], rtol=1e-6)
	np.testing.assert_allclose(U * s[None, :], X @ Vh.conj().T, atol=1e-5)


def test_rand_nystrom_matches_jax_on_its_sketch(monkeypatch):
	n = 64
	ew = np.concatenate([np.linspace(6, 3, 4), 1e-4 * np.ones(n - 4)])
	A = np.array(pt.symmetric(n, pd=True, ew=ew, seed=2))
	w, U = pt.rand_nystrom(A, rank=4, seed=3)
	_inject(monkeypatch, jax_eigen._gaussian_sketch(as_key(3), (n, 12), jnp.float64))
	w2, U2 = ptt.rand_nystrom(torch.from_numpy(A), rank=4, seed=3)
	_close(w2, w, rtol=1e-10)
	_close_up_to_sign(U2, U, atol=1e-8)
	np.testing.assert_allclose(_np(w2), ew[:4], rtol=1e-3)


def test_rand_nystrom_complex_and_indefinite_roundoff():
	n = 48
	ew = np.concatenate([np.linspace(5, 2, 3), np.zeros(n - 3)])
	H = np.array(pt.hermitian(n, pd=False, ew=ew, seed=5))
	w, U = ptt.rand_nystrom(torch.from_numpy(H), rank=3, seed=1)
	np.testing.assert_allclose(_np(w), ew[:3], rtol=1e-6)
	# A PSD matrix with a −1e-10 eigenvalue: the shifted Cholesky retries, no NaN.
	ew2 = np.concatenate([np.linspace(5, 2, 3), np.full(n - 3, -1e-10)])
	B = np.array(pt.symmetric(n, ew=ew2, seed=6))
	w, U = ptt.rand_nystrom(torch.from_numpy(B), rank=3, oversample=n - 3, seed=1)
	assert np.all(np.isfinite(_np(w))) and np.all(np.isfinite(_np(U)))


# --- filtered_eigsh ---


def _slice_case():
	L, lam = _grid(12, 10)
	window = (3.0, 3.3)
	inside = lam[(lam >= window[0]) & (lam <= window[1])]
	return L, lam, window, inside


def test_filtered_eigsh_matches_jax_on_its_sketch(monkeypatch):
	L, lam, window, inside = _slice_case()
	k = len(inside)
	si = (0.0, 8.0)
	w, V = pt.filtered_eigsh(JaxDIA.from_scipy(L, dtype=jnp.float64), window, k=k, spectral_interval=si, seed=4)
	s = k + max(6, k // 4)
	_inject(monkeypatch, jax_eigen._gaussian_sketch(as_key(4), (L.shape[0], s), jnp.float64))
	op = ptt.DIAOperator.from_scipy(L, dtype=torch.float64, device="cpu")
	w2, V2 = ptt.filtered_eigsh(op, window, k=k, spectral_interval=si, seed=4)
	_close(w2, w, rtol=1e-10)
	_close_up_to_sign(V2, V, atol=1e-8)
	np.testing.assert_allclose(_np(w2), inside, atol=1e-6)


def test_filtered_eigsh_grows_when_undercounted_and_complex():
	L, lam, window, inside = _slice_case()
	op = ptt.DIAOperator.from_scipy(L, dtype=torch.float64, device="cpu")
	w, V = ptt.filtered_eigsh(op, window, k=2, spectral_interval=(0.0, 8.0), seed=1, maxiter=60)
	np.testing.assert_allclose(_np(w), inside, atol=1e-6)
	n = 80
	ew = np.linspace(0.0, 4.0, n)
	H = np.array(pt.hermitian(n, ew=ew, seed=7))
	win = (1.0, 1.5)
	w, V = ptt.filtered_eigsh(torch.from_numpy(H), win, k=int(np.sum((ew >= 1.0) & (ew <= 1.5))), spectral_interval=(-0.1, 4.1), seed=2)
	np.testing.assert_allclose(_np(w), ew[(ew >= 1.0) & (ew <= 1.5)], atol=1e-6)
	np.testing.assert_allclose(H @ _np(V), _np(V) * _np(w)[None, :], atol=1e-5)


def test_filtered_eigsh_empty_unresolvable_and_uncounted():
	L, lam, window, inside = _slice_case()
	op = ptt.DIAOperator.from_scipy(L, dtype=torch.float64, device="cpu")
	with pytest.warns(UserWarning, match="outside the estimated spectral range"):
		w, V = ptt.filtered_eigsh(op, (10.0, 11.0), k=3, spectral_interval=(0.0, 8.0))
	assert tuple(w.shape) == (0,) and tuple(V.shape) == (L.shape[0], 0)
	with pytest.warns(UserWarning, match="resolution"):
		w, _ = ptt.filtered_eigsh(op, (3.0, 3.001), k=1, deg=40, spectral_interval=(0.0, 8.0))
	assert tuple(w.shape) == (0,)
	# Uncounted: k from recipes.eigencount of the slice.
	w, V = ptt.filtered_eigsh(op, window, spectral_interval=(0.0, 8.0), seed=3)
	np.testing.assert_allclose(_np(w), inside, atol=1e-6)
	with warnings.catch_warnings():
		warnings.simplefilter("error")
		w, _ = ptt.filtered_eigsh(op, (2.0, 2.2), k=len(lam[(lam >= 2.0) & (lam <= 2.2)]), spectral_interval=(0.0, 8.0), seed=0)
	np.testing.assert_allclose(_np(w), lam[(lam >= 2.0) & (lam <= 2.2)], atol=1e-6)


def test_filtered_eigsh_counts_the_slice_when_k_is_none():
	"""``k=None``: the count comes from ``recipes.eigencount`` (seeded by ``seed``); every pair
	of the window against dense ``eigh``, on a 20 × 16 grid."""
	from primate_tpu_torch import recipes

	L, lam = _grid(20, 16)
	op = ptt.DIAOperator.from_scipy(L, dtype=torch.float64, device="cpu")
	window = (0.5, 1.5)
	inside = lam[(lam > window[0]) & (lam <= window[1])]
	count = recipes.eigencount(op, window, seed=5)
	assert abs(count - inside.size) <= 0.25 * inside.size
	w, V = ptt.filtered_eigsh(op, window, spectral_interval=(0.0, 8.0), seed=5)
	np.testing.assert_allclose(_np(w), inside, atol=1e-6)
	dense = np.linalg.eigh(L.toarray())
	sel = (dense[0] > window[0]) & (dense[0] <= window[1])
	np.testing.assert_allclose(_np(w), dense[0][sel], atol=1e-6)
	U, Vn = dense[1][:, sel], _np(V) / np.linalg.norm(_np(V), axis=0)
	# The same invariant subspace, to the default residual tolerance (1e-6 relative) over the gaps.
	assert np.linalg.norm(Vn @ Vn.T - U @ U.T) < 1e-4
