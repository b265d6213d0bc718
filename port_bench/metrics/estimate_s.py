"""The window's length over the estimates completed in it: a time a step, so a stall counts."""


def read(run):
	return run.window_s / run.completed if run.completed else None
