"""The window's peak of the device memory PyTorch allocated, in 10⁹ bytes (the peak reset after the warm-up)."""


def read(run):
	return run.window_peak_bytes / 1e9
