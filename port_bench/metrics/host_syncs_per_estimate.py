"""Synchronise calls inside any of the program's spans, over the estimates completed (``_spans``):
each waits for the device's queue to drain, one a readback. A count: for one seed it repeats from
run to run."""

from . import _spans


def read(run):
	parts = _spans.split(run)
	if parts is None or not run.trace.device or not run.completed:
		return None
	return sum(p["syncs"] for name, p in parts.items() if name != _spans.OUTSIDE) / run.completed
