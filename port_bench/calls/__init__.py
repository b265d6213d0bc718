"""The calls a traffic file can name (its ``"call"`` key), one module each.

A module gives ``program(ptt, op, traffic)``, the window's call as a function of its seed;
``reference(ref, traffic, seed)``, what the plain reference makes of the same call;
``compare(got, want)``, the numbers that decide ``correct``; ``sweep(traffic)``, the
recurrence the call runs, which the roofline metrics read; and ``faults(traffic, limit)``, the
faults its timed path can have, by name (``port_bench/faults.py``).
"""
