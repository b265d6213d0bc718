"""The operators a configuration can name (its ``"operator"`` key), one module each.

``bands(params, dtype, device)`` builds the operator's DIA bands on the device from its
formulas, row-aligned (``bands[d, i] = A[i, i + offsets[d]]``), with ascending offsets, and
returns ``(bands, offsets, shape)``: the inputs the benchmark hands the program. The reference
of the same kind (``reference/<kind>.py``) applies the operator from the formulas instead.
"""
