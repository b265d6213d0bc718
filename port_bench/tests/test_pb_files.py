"""BENCHMARK.json and the files the harness finds by the names in it."""

import re

import pytest

from port_bench import harness, reference

from .conftest import BENCH, CELLS

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_paths():
	assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
	assert BENCH["paths"] == ["port_bench"]
	assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
	assert BENCH["command"][:3] == ["python3", "-m", "port_bench.run"]


def test_names_units_and_lines():
	entries = BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"] + BENCH["per_layer"]
	for e in entries:
		assert NAME.match(e["name"]), e["name"]
		for key in ("why", "layer", "source"):
			if key in e:
				assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key], (e["name"], key)
	for m in BENCH["end_to_end"] + BENCH["per_layer"]:
		assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
	for group in ("configs", "workloads"):
		names = [e["name"] for e in BENCH[group]]
		assert len(names) == len(set(names))
	metric_names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
	assert len(metric_names) == len(set(metric_names))


def test_bounds():
	e2e = {m["name"]: m for m in BENCH["end_to_end"]}
	assert e2e["setup_s"]["bound"] == 0.25
	for m in e2e.values():
		assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
	for m in BENCH["per_layer"]:
		assert "bound" not in m and m["moves"] in e2e


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_reports_enough(cell):
	e2e = [m["name"] for m in BENCH["end_to_end"] if harness.applies(m, cell)]
	assert "setup_s" in e2e and len(e2e) >= 2
	per = [m for m in BENCH["per_layer"] if harness.applies(m, cell)]
	assert per and all(m["moves"] in e2e for m in per)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
	w = harness.by_name(BENCH["workloads"], cell, "workload")
	assert w["chips"] == 1
	entry = harness.by_name(BENCH["configs"], w["config"], "config")
	assert entry["file"].startswith("port_bench/configs/")
	cfg = harness.load_json(harness.REPO / entry["file"])
	assert cfg["name"] == w["config"] and cfg["reduced"] == entry["reduced"] and cfg["source"] == entry["source"]
	traffic = harness.load_json(harness.ROOT / "traffic" / f"{w['traffic']}.json")
	call = harness.load_module("calls", traffic["call"])
	for fn in ("program", "reference", "compare", "sweep", "faults"):
		assert callable(getattr(call, fn))
	ref = reference.operator(cfg, "float64", "cpu")
	assert ref.n > 0 and callable(ref.apply)
	limits = harness.load_json(harness.ROOT / "cells" / f"{cell}.json")
	assert limits["checked_calls"] >= 1 and limits["limits"]


def config_problems(cfg: dict) -> list:
	"""What keeps a configuration from running through the harness and the benchmark's CPU tests."""
	problems = []
	if cfg.get("format") not in harness.FORMATS:
		problems.append(f"format {cfg.get('format')!r} is none of the harness's {sorted(harness.FORMATS)}")
	else:
		builder = harness.FORMATS[cfg["format"]].builder
		if not callable(getattr(harness.load_module("operators", cfg["operator"]), builder, None)):
			problems.append(f"operators/{cfg['operator']}.py has no {builder}(), "
				f"which format {cfg['format']!r} builds with")
	cpu = cfg.get("cpu")
	if not (isinstance(cpu, dict) and all(isinstance(cpu.get(k), dict) for k in ("params", "control_params"))):
		problems.append("no 'cpu' key with 'params' and 'control_params': the sizes its CPU tests run at")
	return problems


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]])
def test_configuration_has_its_format_and_cpu_sizes(name):
	cfg = harness.load_json(harness.REPO / harness.by_name(BENCH["configs"], name, "config")["file"])
	assert not config_problems(cfg), config_problems(cfg)


def test_configuration_problems_are_named():
	cfg = harness.load_json(harness.REPO / BENCH["configs"][0]["file"])
	assert config_problems(cfg) == []
	assert [p for p in config_problems({k: v for k, v in cfg.items() if k != "cpu"}) if "'cpu'" in p]
	assert [p for p in config_problems({**cfg, "format": "ell"}) if "'ell'" in p]
	assert [p for p in config_problems({**cfg, "format": "bsr"}) if "tiles()" in p]


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
def test_metric_reader_found_by_name(metric):
	assert callable(harness.load_module("metrics", metric).read)


def test_missing_names_raise():
	with pytest.raises(KeyError):
		harness.load_module("metrics", "no_such_metric")
	with pytest.raises(KeyError):
		harness.by_name(BENCH["workloads"], "no_such.cell", "workload")
	with pytest.raises(KeyError, match="'ell'"):
		harness.operator_format({"name": "c", "format": "ell"})
