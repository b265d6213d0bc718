"""One module a metric, named as the metric is in ``BENCHMARK.json``: ``read(run)`` returns its value,
or None where the run has nothing to read, and the harness then leaves the metric out of the line.

``run`` carries the window's host-clock readings (``setup_s``, ``walls``, ``window_s``,
``completed``, ``window_peak_bytes``), the reduced device trace of a ``--trace 1`` run (``trace``,
else None), the call's recurrence (``sweep``), the operator's sizes, the device's name
(``device_kind``) and the program's package directory (``program_dir``). The operator's sizes are
those its format gives (``harness.FORMATS``): ``n``, ``n_d``, ``itemsize`` for DIA; ``n``,
``nnzb``, ``bm``, ``bn``, ``itemsize`` for BSR; ``n``, ``nnz``, ``itemsize`` for CSR. A reader of
one format's sizes lists that format's cells under its ``workloads``.
The arithmetic the metrics share lives in the modules whose names start with ``_``.
"""
