"""Device-idle ms an estimate while the host was inside ``primate.estimate`` but in neither of its
child spans (``_spans``): the probe draw, the estimator's update and criterion, the readbacks."""

from . import _spans


def read(run):
	return _spans.idle_ms(run, "primate.estimate")
