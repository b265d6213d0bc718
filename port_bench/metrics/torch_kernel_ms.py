"""Device milliseconds an estimate in kernels that are not the program's own (PyTorch's, cuBLAS's,
cuSOLVER's): the union of their intervals in the traced window, over the estimates completed."""

from . import _trace


def read(run):
	if run.trace is None or not run.trace.kernels or not run.completed:
		return None
	names = _trace.port_kernel_names(run.program_dir)
	other = [(s, e) for name, _, s, e in run.trace.kernels if not _trace.is_port_kernel(name, names)]
	return _trace.covered(other) / 1e6 / run.completed
