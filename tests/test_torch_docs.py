"""Pin the port's API page (``docs/api_torch.md``) to its code, as ``tests/test_docs.py`` pins
``docs/api.md``: every ``__all__`` name of ``primate_tpu_torch`` and of its ``operators``,
``parallel`` and ``autodiff`` subpackages appears on the page as a code literal, each table row
names its JAX counterpart, and each kernel-backed operator names its ``csrc/`` source, which exists."""

import importlib
import re
from pathlib import Path

import pytest

import primate_tpu_torch as ptt

ROOT = Path(__file__).resolve().parent.parent
DOC = ROOT / "docs" / "api_torch.md"
SUBPACKAGES = ("operators", "parallel", "autodiff")


def _documented(text: str, symbol: str) -> bool:
	# `symbol`, `symbol(...)`, or a dotted form like `module.symbol(...)`
	return f"`{symbol}" in text or f".{symbol}(" in text or f".{symbol}`" in text


def _rows(text: str) -> dict:
	"""The first code literal of each table row (its symbol, arguments cut) → the row."""
	rows = {}
	for line in text.splitlines():
		m = re.match(r"\| `([A-Za-z_][A-Za-z0-9_]*)", line)
		if m:
			rows.setdefault(m.group(1), line)
	return rows


def test_api_torch_docs_cover_top_level_public_symbols():
	text = DOC.read_text()
	missing = [s for s in ptt.__all__ if not _documented(text, s)]
	assert not missing, f"public symbols missing from docs/api_torch.md: {missing}"


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_api_torch_docs_cover_subpackage_symbols(sub):
	mod = importlib.import_module(f"primate_tpu_torch.{sub}")
	text = DOC.read_text()
	missing = [s for s in mod.__all__ if not _documented(text, s)]
	assert not missing, f"{mod.__name__} symbols missing from docs/api_torch.md: {missing}"


def test_every_row_names_its_jax_counterpart():
	rows = _rows(DOC.read_text())
	names = set(ptt.__all__).union(*(importlib.import_module(f"primate_tpu_torch.{sub}").__all__ for sub in SUBPACKAGES))
	lacking = [s for s in sorted(names) if s in rows and "`primate_tpu." not in rows[s]]
	assert not lacking, f"rows without a JAX counterpart: {lacking}"
	assert names <= set(rows), f"names without a row of their own: {sorted(names - set(rows))}"


@pytest.mark.parametrize(
	"symbol, source",
	[
		("DIAOperator", "csrc/dia_stencil.cu"),
		("BSROperator", "csrc/bsr_spmm.cu"),
		("ShardedDIAOperator", "csrc/dia_stencil.cu"),
		("ShardedBSROperator", "csrc/bsr_spmm.cu"),
		("dia_from_numpy", "csrc/dia_stencil.cu"),
		("bsr_from_numpy", "csrc/bsr_spmm.cu"),
	],
)
def test_kernel_backed_names_give_their_source(symbol, source):
	assert source in _rows(DOC.read_text())[symbol]
	assert (ROOT / "primate_tpu_torch" / source).is_file()
