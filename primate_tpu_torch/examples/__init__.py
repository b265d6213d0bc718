"""The repository's examples as scripts of the port (``examples/`` holds the JAX package's).

Each runs on the card with ``python -m primate_tpu_torch.examples.<name>`` and has a
``main(device=None, ...)`` that runs the example's computations, checks them against closed
forms or a dense reference, prints them as the JAX script does and returns its numbers. The
default device is the card; ``device="cpu"`` runs the plain versions of the kernels.
"""

__all__ = ["gp_log_likelihood", "graph_analysis", "rectangular_spectra", "spectrum_slicing", "tight_binding"]
