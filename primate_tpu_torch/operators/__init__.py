"""Operators on torch tensors: the protocol, DIA and BSR, deflation, and matrix functions."""

from .base import DeflatedOperator, DenseOperator, LinearOperator, aslinop, is_valid_operator, quad_form
from .sparse import BSROperator, DIAOperator
from .special_ops import MatrixFunction

__all__ = [
	"LinearOperator",
	"DenseOperator",
	"DeflatedOperator",
	"BSROperator",
	"DIAOperator",
	"MatrixFunction",
	"aslinop",
	"is_valid_operator",
	"quad_form",
]
