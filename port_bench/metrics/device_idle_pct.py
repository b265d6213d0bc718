"""The share of the traced window in which no operation ran on the device, in percent."""


def read(run):
	if run.trace is None or not run.trace.window_ns or not run.trace.busy_ns:
		return None
	return 100.0 * (1.0 - run.trace.busy_ns / run.trace.window_ns)
