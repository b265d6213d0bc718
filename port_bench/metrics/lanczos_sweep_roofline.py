"""The least time of the call's Lanczos steps over its device busy time, in percent (``_roofline``)."""

from . import _roofline


def read(run):
	return _roofline.share_pct(run, "lanczos")
