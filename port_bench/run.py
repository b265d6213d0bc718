"""The port's benchmark, one run of one cell:

    python3 -m port_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, ``port_bench/`` and the program
(``primate_tpu_torch``). Prints the run's account on standard output, one JSON object a line,
and as its last line the result: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each compared number beside its limit, which also close
standard error. Exits with another code than 0, and prints no result, without as many CUDA
devices as the cell asks for, or if JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "primate_tpu")


def loaded_forbidden() -> list:
	"""Modules whose top-level name, compared whole, is JAX's or the JAX package's."""
	return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def main(argv=None) -> int:
	ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
	ap.add_argument("--workload", required=True)
	ap.add_argument("--seed", type=int, required=True)
	ap.add_argument("--seconds", type=float, required=True)
	ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
	args = ap.parse_args(argv)

	import torch

	torch_import_s = time.perf_counter() - T_START
	from port_bench import harness

	bench = harness.load_json(REPO / "BENCHMARK.json")
	chips = int(harness.by_name(bench["workloads"], args.workload, "workload")["chips"])
	if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
		print(f"port_bench: the cell needs {chips} CUDA device(s); "
			f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available", file=sys.stderr)
		return 2
	harness.log(device=torch.cuda.get_device_name(0), device_count=torch.cuda.device_count(), workload=args.workload,
		seed=args.seed, seconds=args.seconds, trace=args.trace, torch_import_s=torch_import_s)
	result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace), device="cuda", t_start=T_START, bench=bench)
	bad = loaded_forbidden()
	if bad:
		print(f"port_bench: the run loaded {bad}", file=sys.stderr)
		return 3
	for key, c in result["checks"].items():
		print(f"check {key} = {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
	print(json.dumps(result), flush=True)
	return 0


if __name__ == "__main__":
	sys.exit(main())
