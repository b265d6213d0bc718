"""Device-idle ms an estimate while the host was inside ``primate.sweep`` (``_spans``): the host's
gaps between the recurrence's launches."""

from . import _spans


def read(run):
	return _spans.idle_ms(run, "primate.sweep")
