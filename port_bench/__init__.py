"""The benchmark of ``primate_tpu_torch`` on the card: ``python3 -m port_bench.run --workload <cell> ...``.

Driven by data: ``BENCHMARK.json`` at the checkout's root names the cells, and each cell's
configuration, traffic, limits, call, operator and metrics are files of their own here, found by name
(see :mod:`port_bench.harness`). Nothing here imports JAX or the JAX package.
"""
