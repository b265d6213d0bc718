"""The port held to the JAX package's public contract, on the CPU at small size.

(a) Signatures: every public callable of ``primate_tpu.__all__`` and of every JAX submodule's
``__all__`` (one case per object), and every public method and member of every public class,
inherited ones included, against the port's counterpart by ``inspect.signature``: JAX's
positional parameters keep their names and places, every JAX parameter exists in the port,
every plain-valued JAX default is the port's, a JAX default is never a required port
parameter, and a parameter the port adds has a default. A name the port does not have at all
is ``test_torch_exports.py``'s concern (``NOT_PORTED``).

(b) Result records: every entry point that takes ``full=True``, and each recipe that passes it
through, on the same 48×48 SPD matrix in both packages. The record's structure is compared: the
estimator's and criterion's classes, whether ``message`` is set, ``info``'s keys, the length of
``samples``, tuple unpacking, whether the estimator tracks a covariance and where ``record=True``
keeps its values; and, call by call, what a ``callback`` receives. The sample count is compared
where a count criterion fixes it (the two packages draw different probes).

(c) One check per fault that (a) and (b) found: the special functions' first argument,
``EstimatorResult.samples``, its unpacking, ``diag``'s record, ``MeanEstimator``'s
``covariance`` flag, ``DIAOperator.from_dense`` and ``DeflatedOperator.matmat_t``'s argument.
Values are held to JAX's at float64 on the same numpy inputs, to 1e-12 relative.

A deliberate difference stands in ``CONTRACT_DIFFERENCES``, with its reason: a key is a tag that
the checks above produce (``"name(param)"``, ``"Class.member"``, ``"case: field"``) or an
``fnmatch`` pattern of tags. Every entry must still match a difference, and none may cover a
fault of (c).
"""

import dataclasses
import fnmatch
import importlib
import inspect
import pkgutil

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import primate_tpu as pt
import primate_tpu_torch as ptt
from test_torch_exports import NOT_PORTED, NOT_PORTED_MODULES

torch.set_num_threads(1)
RTOL = 1e-12

CONTRACT_DIFFERENCES = {
	"sample_isotropic(key)": "a JAX PRNG key; the port draws from the torch.Generator it takes in that place",
	"sample_isotropic(generator)": "the torch.Generator the port draws from, in the place of JAX's PRNG key",
	"*(use_pallas)": "the switch to a Pallas TPU kernel; the port launches its CUDA kernel for a tensor on the card",
	"*(interpret)": "Pallas interpret mode, which has no CUDA counterpart",
	"*(rowids)": "a TPU layout (the sliced-ELL row ids); ROADMAP 'Code not to port'",
	"*(ell_data)": "a TPU layout (sliced ELL); ROADMAP 'Code not to port'",
	"*(ell_idx)": "a TPU layout (sliced ELL); ROADMAP 'Code not to port'",
	"*(tail)": "a TPU layout (the sliced-ELL overflow); ROADMAP 'Code not to port'",
	"*(bell)": "a TPU layout (blocked ELL of BSR tiles); ROADMAP 'Code not to port'",
	"*(rows_sorted)": "a TPU layout flag of the COO scatter; ROADMAP 'Code not to port'",
	"DIAOperator.phys_spec": "the TPU's padded lane layout of the Lanczos carry; ROADMAP 'Code not to port'",
	"DIAOperator.matmat_t_phys": "the stencil on the TPU's padded carry layout; ROADMAP 'Code not to port'",
	"CSROperator.*_MAX_*": "a sliced-ELL size limit of the TPU layout; ROADMAP 'Code not to port'",
	"CSROperator.SELL_MIN_ROWS": "a sliced-ELL size limit of the TPU layout; ROADMAP 'Code not to port'",
	"BSROperator.*_MAX_*": "a blocked-ELL size limit of the TPU layout; ROADMAP 'Code not to port'",
	"*.tree_flatten": "JAX pytree registration; torch has no pytree protocol for operators",
	"*.tree_unflatten": "JAX pytree registration; torch has no pytree protocol for operators",
	"ShardedCSROperator(*)": "JAX's constructor takes per-device arrays on a Mesh; the port's is built by from_csr over a process group",
	"ShardedBSROperator(*)": "JAX's constructor takes per-device arrays on a Mesh; the port's is built by from_bsr over a process group",
	"ShardedDIAOperator(*)": "JAX's constructor takes per-device arrays on a Mesh; the port's is built by from_dia over a process group",
	"lanczos(**kwargs)": "JAX warns and drops an unknown keyword; the port names its keywords and raises TypeError",
	"quadrature(**kwargs)": "JAX forwards **kwargs to its tridiagonal eigensolver; the port names them (method, maxiter)",
	"xtrace_*: callback *": "the port's callback sees the round's estimator and the criterion, as hutch's and diag's "
	"callbacks do in both packages; JAX's xtrace passes None for both until it returns",
}

# The faults the checks found, by tag: CONTRACT_DIFFERENCES may cover none of them.
FAULT_TAGS = [
	"softsign(x)", "smoothstep(x)", "exp(x)", "step(x)",
	"EstimatorResult(samples)", "xnystrace: samples", "hutchpp: samples", "hutch: unpack",
	"diag: estimator", "diag_callback: callback estimator", "diag_record: values", "diag: info",
	"MeanEstimator(covariance)", "xnystrace: cov",
	"DIAOperator.from_dense",
	"DeflatedOperator.matmat_t(Wt)",
]


def _covered(tag: str) -> bool:
	return any(fnmatch.fnmatchcase(tag, pat) for pat in CONTRACT_DIFFERENCES)


# --- (a) signatures ----------------------------------------------------------------------------

_POSITIONAL = (inspect.Parameter.POSITIONAL_ONLY, inspect.Parameter.POSITIONAL_OR_KEYWORD)
_VAR = {inspect.Parameter.VAR_POSITIONAL: "*", inspect.Parameter.VAR_KEYWORD: "**"}


def _public_objects() -> list:
	"""(dotted path, JAX object, port object) for every callable of ``primate_tpu.__all__`` and of
	each JAX submodule's ``__all__``, once per JAX object, under its first path."""
	mods = [""] + sorted(
		m.name.removeprefix("primate_tpu.") for m in pkgutil.walk_packages(pt.__path__, "primate_tpu.")
		if m.name.removeprefix("primate_tpu.") not in NOT_PORTED_MODULES
	)
	seen, out = set(), []
	for m in mods:
		jmod = pt if not m else importlib.import_module(f"primate_tpu.{m}")
		pmod = ptt if not m else importlib.import_module(f"primate_tpu_torch.{m}")
		for name in getattr(jmod, "__all__", ()):
			obj = getattr(jmod, name)
			if (m, name) in NOT_PORTED or not callable(obj) or id(obj) in seen or not hasattr(pmod, name):
				continue
			seen.add(id(obj))
			out.append((f"{m}.{name}" if m else name, obj, getattr(pmod, name)))
	return out


_MISSING = object()


def _members() -> list:
	"""(path, Class.member, JAX member, port member or ``_MISSING``) for every public member of every public class."""
	out = []
	for path, jcls, pcls in _public_objects():
		if not inspect.isclass(jcls):
			continue
		for name in sorted(n for n in dir(jcls) if not n.startswith("_")):
			out.append((f"{path}.{name}", f"{jcls.__name__}.{name}", getattr(jcls, name), getattr(pcls, name, _MISSING)))
	return out


OBJECTS = _public_objects()
MEMBERS = _members()


def _signature(obj):
	try:
		return inspect.signature(obj)
	except (TypeError, ValueError):
		return None


def _plain(v) -> bool:
	return v is None or isinstance(v, (bool, int, float, str, tuple))


def signature_differences(tag: str, jobj, pobj) -> list:
	"""``(tag, text)`` for each way ``pobj``'s signature breaks ``jobj``'s contract."""
	sj, sp = _signature(jobj), _signature(pobj)
	if sj is None or sp is None:
		return [] if (sj is None) == (sp is None) else [(tag, f"signature {sj} vs {sp}")]
	jp = {n: p for n, p in sj.parameters.items() if not n.startswith("_")}
	pp = sp.parameters
	jpos = [n for n, p in jp.items() if p.kind in _POSITIONAL]
	ppos = [n for n, p in pp.items() if p.kind in _POSITIONAL]
	out = []
	for name, p in jp.items():
		ptag = f"{tag}({_VAR.get(p.kind, '')}{name})"
		if p.kind in _VAR:
			if not any(q.kind == p.kind for q in pp.values()):
				out.append((ptag, f"JAX takes {_VAR[p.kind]}{name}; the port does not"))
			continue
		q = pp.get(name)
		if q is None:
			out.append((ptag, f"JAX's parameter {name} is missing"))
			continue
		if p.kind in _POSITIONAL and (q.kind not in _POSITIONAL or ppos.index(name) != jpos.index(name)):
			out.append((ptag, f"{name} is positional {jpos.index(name)} in JAX, not in the port ({ppos})"))
		if p.default is not inspect.Parameter.empty:
			if q.default is inspect.Parameter.empty:
				out.append((ptag, f"{name} has a default in JAX, none in the port"))
			elif _plain(p.default) and _plain(q.default) and p.default != q.default:
				out.append((ptag, f"default of {name}: {p.default!r} in JAX, {q.default!r} in the port"))
	for name, q in pp.items():
		if name not in jp and q.kind not in _VAR and q.default is inspect.Parameter.empty and name not in sj.parameters:
			out.append((f"{tag}({name})", f"the port requires {name}, which JAX does not take"))
	return out


def class_differences(tag: str, jcls, pcls) -> list:
	out = signature_differences(tag, jcls, pcls)
	jfields = [f.name for f in dataclasses.fields(jcls)] if dataclasses.is_dataclass(jcls) else list(getattr(jcls, "_fields", ()))
	pfields = [f.name for f in dataclasses.fields(pcls)] if dataclasses.is_dataclass(pcls) else list(getattr(pcls, "_fields", ()))
	out += [(f"{tag}({f})", f"JAX's field {f} is missing") for f in jfields if f not in pfields]
	return out


def object_differences(path: str, jobj, pobj) -> list:
	tag = jobj.__name__
	return class_differences(tag, jobj, pobj) if inspect.isclass(jobj) else signature_differences(tag, jobj, pobj)


def member_differences(tag: str, jm, pm) -> list:
	if pm is _MISSING:
		return [(tag, "missing in the port")]
	return signature_differences(tag, jm, pm) if callable(jm) and not inspect.isclass(jm) else []


def _uncovered(diffs: list) -> list:
	return [f"{t}: {text}" for t, text in diffs if not _covered(t)]


@pytest.mark.parametrize("path,jobj,pobj", OBJECTS, ids=[o[0] for o in OBJECTS])
def test_public_signature_matches_jax(path, jobj, pobj):
	assert not _uncovered(object_differences(path, jobj, pobj))


@pytest.mark.parametrize("path,tag,jm,pm", MEMBERS, ids=[m[0] for m in MEMBERS])
def test_public_member_matches_jax(path, tag, jm, pm):
	assert not _uncovered(member_differences(tag, jm, pm))


def _signature_tags() -> set:
	tags = {t for path, j, p in OBJECTS for t, _ in object_differences(path, j, p)}
	return tags | {t for _, tag, j, p in MEMBERS for t, _ in member_differences(tag, j, p)}


# --- (b) result records ------------------------------------------------------------------------


def _spd(n: int = 48) -> np.ndarray:
	rng = np.random.default_rng(0)
	Q, _ = np.linalg.qr(rng.normal(size=(n, n)))
	return (Q * np.linspace(0.5, 2.0, n)) @ Q.T


A_NP = _spd()
EST = dict(converge="count", count=8, batch=4, seed=3, full=True)

# name → (call(package, operator), whether a count criterion fixes the sample count)
RECORD_CASES = {
	"hutch": (lambda P, A: P.hutch(A, **EST), True),
	"hutch_matfun": (lambda P, A: P.hutch(P.MatrixFunction(A, "log", deg=10, orth=0), **EST), True),
	"hutch_default": (lambda P, A: P.hutch(A, seed=3, full=True), False),
	"hutchpp": (lambda P, A: P.hutchpp(A, m=12, seed=3, full=True), True),
	"hutchpp_adaptive": (lambda P, A: P.hutchpp(A, m=12, **EST), True),
	"xtrace": (lambda P, A: P.xtrace(A, batch=8, converge="count", count=16, seed=3, full=True), True),
	"xnystrace": (lambda P, A: P.xnystrace(A, m=12, seed=3, full=True), True),
	"diag": (lambda P, A: P.diag(A, converge="count", count=6, batch=2, seed=3, full=True), True),
	"diag_tolerance": (lambda P, A: P.diag(A, converge="tolerance", rtol=0.05, batch=2, seed=3, full=True), False),
	"diag_confidence": (lambda P, A: P.diag(A, converge="confidence", rtol=0.05, batch=2, seed=3, full=True, maxiter=20), False),
	"kpm_trace": (lambda P, A: P.kpm.kpm_trace(A, "log", m=16, nv=4, seed=3, interval=(0.4, 2.1), full=True), True),
	"block_slq_trace": (lambda P, A: P.block_slq_trace(A, "log", b=4, deg=8, nblocks=2, seed=3, full=True), True),
	"logdet": (lambda P, A: P.recipes.logdet(A, deg=10, **EST), True),
	"trace_inv": (lambda P, A: P.recipes.trace_inv(A, deg=10, **EST), True),
	"estrada_index": (lambda P, A: P.recipes.estrada_index(A, deg=10, **EST), True),
	"heat_kernel_trace": (lambda P, A: P.recipes.heat_kernel_trace(A, t=np.array([0.5, 1.0]), deg=10, **EST), True),
	"heat_kernel_signature": (lambda P, A: P.recipes.heat_kernel_signature(
		A, np.array([0.5, 1.0]), deg=10, converge="count", count=4, batch=2, seed=3, full=True), True),
	"numrank": (lambda P, A: P.recipes.numrank(A, threshold=0.1, deg=10, **EST), True),
	"eigencount": (lambda P, A: P.recipes.eigencount(A, (0.8, 1.5), deg=10, **EST), True),
	"schatten": (lambda P, A: P.recipes.schatten(A, p=2.0, deg=10, **EST), True),
	"effective_dim": (lambda P, A: P.recipes.effective_dim(A, lam=1.0, deg=10, **EST), True),
	"slogdet": (lambda P, A: P.recipes.slogdet(A, deg=10, count_deg=10, **EST), True),
	"shifted_trace": (lambda P, A: P.recipes.shifted_trace(A, "log", shifts=np.array([0.1, 0.2]), deg=10, **EST), True),
	"deflated_trace": (lambda P, A: P.recipes.deflated_trace(A, "log", k=4, deg=10, **EST), True),
	"weighted_trace": (lambda P, A: P.recipes.weighted_trace(A, A, "log", deg=10, **EST), True),
	"trace_bounds": (lambda P, A: P.recipes.trace_bounds(A, "log", deg=8, nv=4, seed=3, full=True), True),
	"suggest_degree": (lambda P, A: P.recipes.suggest_degree(A, "log", nv=4, seed=3, max_deg=16, full=True), True),
	"suggest_probes": (lambda P, A: P.recipes.suggest_probes(A, "log", pilot=8, deg=8, seed=3, full=True), True),
}

# name → call(package, operator, callback, record): the entry points that take a callback.
CALLBACK_CASES = {
	"hutch": lambda P, A, cb, rec: P.hutch(A, callback=cb, record=rec, **EST),
	"xtrace": lambda P, A, cb, rec: P.xtrace(A, batch=8, converge="count", count=16, seed=3, full=True, callback=cb, record=rec),
	"diag": lambda P, A, cb, rec: P.diag(A, converge="count", count=3, batch=2, seed=3, full=True, callback=cb, record=rec),
	"diag_resumed": lambda P, A, cb, rec: P.diag(
		A, converge="count", count=5, batch=2, seed=3, full=True, callback=cb, record=rec,
		resume=P.diag(A, converge="count", count=3, batch=2, seed=3, full=True)[1]),
}


def _operator(P):
	return jnp.asarray(A_NP) if P is pt else torch.from_numpy(A_NP)


def record_of(res, with_nit: bool = True) -> dict:
	"""The structure of an ``EstimatorResult``."""
	est = res.estimator
	out = {
		"estimator": None if est is None else type(est).__name__,
		"criterion": None if res.criterion is None else type(res.criterion).__name__,
		"message": bool(res.message),
		"info": sorted(res.info),
		"samples": None if getattr(res, "samples", None) is None else len(res.samples),
		"estimate": np.shape(np.asarray(res.estimate)),
		"cov": None if est is None else est.converged_variance is not None,
		"values": None if est is None or est.values is None else len(est.values),
	}
	try:
		out["unpack"] = [type(x).__name__ for x in res][2:]
	except TypeError:
		out["unpack"] = None
	if with_nit:
		out["nit"] = int(res.nit)
	return out


def structure_of(out, with_nit: bool = True):
	"""What an entry point returns: a record's structure, a tuple's items', an array's shape."""
	if isinstance(out, (pt.EstimatorResult, ptt.EstimatorResult)):
		return record_of(out, with_nit)
	if isinstance(out, tuple):
		return ("tuple", [structure_of(o, with_nit) for o in out])
	if isinstance(out, dict):
		return ("dict", sorted(out))
	if isinstance(out, list):
		return ("list", len(out))
	if hasattr(out, "shape"):
		return ("array", tuple(out.shape))
	return type(out).__name__


def _find_record(s):
	if isinstance(s, dict):
		return s
	if isinstance(s, tuple) and s[0] == "tuple":
		return next((r for r in map(_find_record, s[1]) if r is not None), None)
	return None


def record_differences(case: str) -> list:
	"""``(tag, text)`` for each way the port's return of ``case`` differs from JAX's in structure."""
	call, fixed = RECORD_CASES[case]
	j, p = (structure_of(call(P, _operator(P)), fixed) for P in (pt, ptt))
	if j == p:
		return []
	jr, pr = _find_record(j), _find_record(p)
	if jr is None or pr is None:
		return [(f"{case}: return", f"JAX {j} vs the port {p}")]
	return [(f"{case}: {k}", f"JAX {jr.get(k)!r} vs the port {pr.get(k)!r}") for k in sorted(set(jr) | set(pr)) if jr.get(k) != pr.get(k)]


def callback_differences(case: str, record: bool) -> list:
	"""``(tag, text)`` for each way what the port's callback receives, or its final record, differs from JAX's."""
	seen = {}
	for P in (pt, ptt):
		calls = seen[P] = []
		_, res = CALLBACK_CASES[case](P, _operator(P), lambda r: calls.append(record_of(r)), record)
		calls.append(record_of(res))
	j, p = seen[pt], seen[ptt]
	name = f"{case}_{'record' if record else 'callback'}"
	if len(j) != len(p):
		return [(f"{name}: callback calls", f"JAX {len(j) - 1} vs the port {len(p) - 1}")]
	out = set()
	for i, (jr, pr) in enumerate(zip(j, p)):
		last = i == len(j) - 1
		out |= {(f"{name}: {'' if last else 'callback '}{k}", f"JAX {jr[k]!r} vs the port {pr[k]!r}") for k in jr if jr[k] != pr[k]}
	return sorted(out)


@pytest.mark.parametrize("case", sorted(RECORD_CASES))
def test_result_record_matches_jax(case):
	assert not _uncovered(record_differences(case))


@pytest.mark.parametrize("record", [False, True], ids=["callback", "record"])
@pytest.mark.parametrize("case", sorted(CALLBACK_CASES))
def test_callback_and_record_match_jax(case, record):
	assert not _uncovered(callback_differences(case, record))


# --- the list of differences itself ------------------------------------------------------------


def test_every_listed_difference_has_a_reason():
	assert all(isinstance(r, str) and len(r.split()) >= 4 for r in CONTRACT_DIFFERENCES.values())


def test_no_fault_is_listed_as_a_difference():
	assert not [t for t in FAULT_TAGS if _covered(t)]


def _tags_of(pattern: str) -> set:
	"""The tags of every check that ``pattern`` can name: the callback and record runs whose
	names its ``case:`` prefix matches, else the signatures."""
	if ":" not in pattern:
		return _signature_tags()
	case = pattern.split(":")[0]
	tags = set()
	for name in CALLBACK_CASES:
		for flag in (False, True):
			if fnmatch.fnmatchcase(f"{name}_{'record' if flag else 'callback'}", case):
				tags |= {t for t, _ in callback_differences(name, flag)}
	for name in RECORD_CASES:
		if fnmatch.fnmatchcase(name, case):
			tags |= {t for t, _ in record_differences(name)}
	return tags


@pytest.mark.parametrize("pattern", sorted(CONTRACT_DIFFERENCES))
def test_each_listed_difference_still_differs(pattern):
	tags = _tags_of(pattern)
	assert any(fnmatch.fnmatchcase(t, pattern) for t in tags), f"{pattern} no longer differs: take it off CONTRACT_DIFFERENCES"


# --- (c) one check per fault -------------------------------------------------------------------

NODES = np.linspace(-1.5, 1.5, 41)
SPECIAL = {
	"softsign": dict(q=3),
	"smoothstep": dict(a=-0.2, b=0.3, deg=5),
	"exp": dict(t=-0.5),
	"step": dict(c=0.1),
}


@pytest.mark.parametrize("name", sorted(SPECIAL))
def test_fault1_special_functions_take_the_nodes_first(name):
	"""Given the nodes first, each special function evaluates them as JAX's does (a numpy array on
	the device asked for, a tensor where it lies); without them it is the function."""
	kw = SPECIAL[name]
	jf, pf = getattr(pt.special, name), getattr(ptt.special, name)
	want = np.asarray(jf(jnp.asarray(NODES), **kw))
	got = pf(NODES, **kw, device="cpu")
	np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=0)
	x = torch.from_numpy(NODES)
	assert torch.equal(pf(x, **kw), pf(**kw)(x)) and pf(x, **kw).dtype == torch.float64
	assert callable(pf(**kw)) and not isinstance(pf(**kw), torch.Tensor)


def test_fault1_exp_and_step_of_a_number():
	assert abs(float(ptt.special.exp(2.0, device="cpu")) - float(pt.special.exp(2.0))) <= RTOL * np.exp(2.0)
	np.testing.assert_array_equal(ptt.special.step(np.array([1.0, -1.0]), device="cpu").numpy(), np.asarray(pt.special.step(jnp.array([1.0, -1.0]))))


def _blocks(n: int, shapes: list, seed: int) -> list:
	rng = np.random.default_rng(seed)
	return [rng.standard_normal(s) for s in shapes]


def _injected(P, blocks: list):
	"""A ``(key or generator, shape, dtype)`` pdf that hands out ``blocks`` in turn."""
	stream = iter(blocks)
	if P is pt:
		return lambda key, shape, dtype: jnp.asarray(next(stream), dtype)
	return lambda gen, shape, dtype: torch.from_numpy(next(stream)).to(dtype)


@pytest.mark.parametrize("name,m,rounds", [("hutchpp", 12, 2), ("xnystrace", 12, 1)])
def test_fault2_sketch_records_carry_samples(name, m, rounds):
	"""``hutchpp`` and ``xnystrace`` keep their per-probe estimates in ``result.samples``, equal
	to JAX's on injected probe blocks; ``info`` holds none."""
	blocks = _blocks(48, [(48, m)] * rounds, seed=7)
	(jest, jres), (est, res) = (getattr(P, name)(_operator(P), m=m, pdf=_injected(P, blocks), full=True) for P in (pt, ptt))
	assert "samples" not in res.info and len(res.samples) == len(jres.samples)
	np.testing.assert_allclose(res.samples, np.asarray(jres.samples), rtol=RTOL, atol=RTOL * np.abs(jres.samples).max())
	np.testing.assert_allclose(est, jest, rtol=RTOL)
	if name == "xnystrace":
		assert res.estimator.converged_variance is not None
		np.testing.assert_allclose(res.estimator.converged_variance, jres.estimator.converged_variance, rtol=RTOL)


def test_fault3_estimator_result_unpacks():
	_, jres = pt.hutch(_operator(pt), **EST)
	_, res = ptt.hutch(_operator(ptt), **EST)
	jfields, fields = list(jres), list(res)
	assert len(fields) == len(jfields) == 6
	assert [type(x).__name__ for x in fields] == [type(x).__name__ for x in jfields]
	estimator, criterion, estimate, message, nit, info = res
	assert (estimator, criterion, estimate, message, nit, info) == (res.estimator, res.criterion, res.estimate, res.message, res.nit, res.info)


def test_fault4_diag_record_is_jax():
	"""``diag(full=True)``: a covariance-free ``MeanEstimator`` that the callback sees each iteration,
	the recorded ratio estimates in its ``values`` (JAX's to 1e-12 on the same host probes), the
	criterion's message, and ``info`` with ``state`` only; ``resume`` still continues from it."""
	blocks = _blocks(48, [(48, 2)] * 3, seed=9)
	runs = {}
	for P in (pt, ptt):
		stream, seen = iter(blocks), []
		est, res = P.diag(_operator(P), pdf=lambda size: next(stream), converge="count", count=3, batch=2, full=True,
			record=True, callback=lambda r: seen.append(r.estimator))
		runs[P] = (est, res, seen)
	(jest, jres, jseen), (est, res, seen) = runs[pt], runs[ptt]
	assert isinstance(res.estimator, ptt.MeanEstimator) and res.estimator.converged_variance is None
	assert len(seen) == 3 and all(s is res.estimator for s in seen)
	assert sorted(res.info) == sorted(jres.info) == ["state"] and res.message
	np.testing.assert_allclose(res.estimator.values, jres.estimator.values, rtol=RTOL, atol=RTOL)
	np.testing.assert_allclose(res.estimator.estimate, np.asarray(est), rtol=0, atol=0)
	np.testing.assert_allclose(est, np.asarray(jest), rtol=RTOL)
	op = _operator(ptt)
	first = ptt.diag(op, converge="count", count=2, batch=2, seed=5, full=True)[1]
	resumed = ptt.diag(op, converge="count", count=4, batch=2, seed=5, resume=first)
	assert np.array_equal(resumed, ptt.diag(op, converge="count", count=4, batch=2, seed=5))


def test_fault5_mean_estimator_takes_the_covariance_flag():
	"""``MeanEstimator(dim, covariance, record, dtype)`` in JAX's order; ``converged_variance`` is
	JAX's with the flag and None without it; ``from_state`` sets the flag from the state's type."""
	x = np.random.default_rng(5).normal(size=(13, 1))
	for cov in (False, True):
		est, jest = ptt.MeanEstimator(1, cov, True, device="cpu"), pt.MeanEstimator(1, cov, True)
		est.update(x)
		jest.update(x)
		assert est.values == pytest.approx(jest.values, rel=RTOL) and len(est.values) == 13
		if cov:
			assert est.converged_variance == pytest.approx(jest.converged_variance, rel=RTOL)
		else:
			assert est.converged_variance is None is jest.converged_variance
		back = ptt.MeanEstimator.from_state(est.state, values=est.values, n_values=5)
		jback = pt.MeanEstimator.from_state(jest._moments._state, values=jest.values, n_values=5)
		assert (back.converged_variance is None) == (jback.converged_variance is None) == (not cov)
		assert len(back.values) == len(jback.values) == 5


def test_fault6_dia_from_dense():
	"""``DIAOperator.from_dense``: JAX's bands and offsets (through ``dia_matrix``), and its product."""
	rng = np.random.default_rng(6)
	n = 40
	D = np.diag(rng.uniform(1, 2, n)) + np.diag(rng.uniform(-0.3, 0.3, n - 2), 2) + np.diag(rng.uniform(-0.3, 0.3, n - 5), -5)
	jop, op = pt.operators.DIAOperator.from_dense(D), ptt.DIAOperator.from_dense(D, device="cpu")
	assert op.offsets == tuple(int(o) for o in jop.offsets)
	np.testing.assert_array_equal(op.bands.numpy()[:, :n], np.asarray(jop.bands)[:, :n])
	v = rng.normal(size=n)
	np.testing.assert_allclose(op.matvec(torch.from_numpy(v)).numpy(), D @ v, rtol=RTOL, atol=RTOL)


def test_fault7_deflated_matmat_t_takes_wt():
	rng = np.random.default_rng(7)
	V, _ = np.linalg.qr(rng.normal(size=(48, 3)))
	Wt = rng.normal(size=(5, 48))
	want = np.asarray(pt.operators.DeflatedOperator(jnp.asarray(A_NP), jnp.asarray(V), fill=0.5).matmat_t(Wt=jnp.asarray(Wt)))
	got = ptt.DeflatedOperator(torch.from_numpy(A_NP), torch.from_numpy(V), fill=0.5).matmat_t(Wt=torch.from_numpy(Wt))
	np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=RTOL * np.abs(want).max())
