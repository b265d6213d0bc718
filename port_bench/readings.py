"""The readings a cell's limits are set from: the largest of each compared number over a run's
checked calls, seed by seed, for the program as it runs (``--side program``), for the
configuration's lower-precision control in its place (``--side control``), or for the program with
one of the faults its timed path can have planted underneath (``--side half_batch`` and the other
names of the call's ``faults``):

    python3 -m port_bench.readings --workload <cell> --seeds 11,12,13 --side control

One process builds the cell once and reads every seed; a seed's calls are the first
``checked_calls`` of a run with that seed, so the numbers are those a run of it would compare.
The benchmark's runs never call this. Prints one JSON line a seed and a summary line.
"""

import argparse
import sys
import time


def readings(name: str, seeds: list, control: bool, device="cuda", params: dict = None, fault: str = None) -> list:
	"""``[{"seed", numbers..., "call_s", "reference_s"}]``, one entry a seed."""
	import primate_tpu_torch as ptt

	from port_bench import harness

	cell = harness.Cell(name, device, params=params, control=control)
	if fault is not None:
		cell.faults()[fault](setattr)
	cell.build(ptt)
	k, rows = int(cell.limits["checked_calls"]), []
	for seed in seeds:
		t0 = time.perf_counter()
		outputs = {}
		for i in range(k):
			outputs[i] = cell.fn(harness.call_seed(seed, i))
		harness.sync(cell.device)
		t1 = time.perf_counter()
		rows.append({"seed": seed, **cell.check(seed, outputs), "call_s": (t1 - t0) / k, "reference_s": (time.perf_counter() - t1) / k})
		harness.log(**rows[-1])
	return rows


def main(argv=None) -> int:
	ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
	ap.add_argument("--workload", required=True)
	ap.add_argument("--seeds", required=True, help="comma-separated")
	ap.add_argument("--side", required=True, help="program, control, or the name of a fault of the cell's call")
	args = ap.parse_args(argv)
	from port_bench import harness

	fault = None if args.side in ("program", "control") else args.side
	rows = readings(args.workload, [int(s) for s in args.seeds.split(",")], args.side == "control", fault=fault)
	keys = [k for k in rows[0] if k not in ("seed", "call_s", "reference_s")]
	harness.log(workload=args.workload, side=args.side, seeds=len(rows),
		**{f"{k}_max": max(r[k] for r in rows) for k in keys}, **{f"{k}_min": min(r[k] for r in rows) for k in keys})
	return 0


if __name__ == "__main__":
	sys.exit(main())
