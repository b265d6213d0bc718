"""The least time of the call's Chebyshev steps over its device busy time, in percent (``_roofline``)."""

from . import _roofline


def read(run):
	return _roofline.share_pct(run, "chebyshev")
