"""Seconds from the process's start to the first timed call: imports, the kernels' load (or build),
the operator's build on the device and the warm-up call."""


def read(run):
	return run.setup_s
