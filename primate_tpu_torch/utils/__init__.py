"""Utility helpers: kwargs routing (:mod:`.kwargs`), estimator checkpoints (:mod:`.checkpoint`)
and profiling (:mod:`.profiling`)."""

from . import checkpoint, kwargs, profiling
from .kwargs import restrict_kwargs, setdiff_kwargs

__all__ = ["restrict_kwargs", "setdiff_kwargs", "checkpoint", "kwargs", "profiling"]
