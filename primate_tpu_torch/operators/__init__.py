"""Operators on torch tensors: the protocol, DIA, and matrix functions."""

from .base import DenseOperator, LinearOperator, aslinop, is_valid_operator, quad_form
from .sparse import DIAOperator
from .special_ops import MatrixFunction

__all__ = ["LinearOperator", "DenseOperator", "DIAOperator", "MatrixFunction", "aslinop", "is_valid_operator", "quad_form"]
