"""Operators on torch tensors: the protocol and its algebra, COO, CSR, DIA and BSR, deflation,
matrix functions and the Gershgorin enclosure."""

from .base import (
	AdjointOperator,
	AffineOperator,
	ComposedOperator,
	DeflatedOperator,
	DenseOperator,
	FunctionOperator,
	LinearOperator,
	ScaledOperator,
	aslinop,
	is_linear_op,
	is_valid_operator,
	matmat,
	quad_form,
)
from .prepare import gershgorin_interval
from .sparse import BSROperator, COOOperator, CSROperator, DIAOperator
from .special_ops import MatrixFunction, matrix_function

__all__ = [
	"LinearOperator",
	"DenseOperator",
	"DeflatedOperator",
	"FunctionOperator",
	"AffineOperator",
	"ScaledOperator",
	"ComposedOperator",
	"AdjointOperator",
	"COOOperator",
	"CSROperator",
	"BSROperator",
	"DIAOperator",
	"MatrixFunction",
	"matrix_function",
	"aslinop",
	"is_linear_op",
	"is_valid_operator",
	"matmat",
	"quad_form",
	"gershgorin_interval",
]
