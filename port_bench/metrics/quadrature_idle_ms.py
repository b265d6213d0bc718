"""Device-idle ms an estimate while the host was inside ``primate.quadrature`` (``_spans``): the
rule's eigensolver, its launches and copies, and the series or broadening after it."""

from . import _spans


def read(run):
	return _spans.idle_ms(run, "primate.quadrature")
