"""Kernels the device ran in the traced window, over the estimates completed in it."""


def read(run):
	if run.trace is None or not run.trace.kernels or not run.completed:
		return None
	return len(run.trace.kernels) / run.completed
