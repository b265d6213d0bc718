"""One module a metric, named as the metric is in ``BENCHMARK.json``: ``read(run)`` returns its value,
or None where the run has nothing to read, and the harness then leaves the metric out of the line.

``run`` carries the window's host-clock readings (``setup_s``, ``walls``, ``window_s``,
``completed``, ``window_peak_bytes``), the reduced device trace of a ``--trace 1`` run (``trace``,
else None), the call's recurrence (``sweep``), the operator's sizes (``n``, ``n_d``, ``itemsize``),
the device's name (``device_kind``) and the program's package directory (``program_dir``).
The arithmetic the metrics share lives in the modules whose names start with ``_``.
"""
