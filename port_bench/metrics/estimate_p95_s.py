"""The 95th percentile of the walls of all the window's calls (linear interpolation)."""

import numpy as np


def read(run):
	return float(np.percentile(run.walls, 95)) if run.walls else None
