"""Operators on torch tensors: the protocol and its algebra, COO, CSR, DIA and BSR, the Gram
operator, deflation, matrix functions, Toeplitz, the format choice (``auto_operator``) and
the Gershgorin enclosure."""

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
from .prepare import PrepInfo, auto_operator, bandwidth, gershgorin_interval, reorder_rcm
from .sparse import BSROperator, COOOperator, CSROperator, DIAOperator, GramOperator
from .special_ops import MatrixFunction, Toeplitz, matrix_function, normalize_unit

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
	"GramOperator",
	"MatrixFunction",
	"Toeplitz",
	"normalize_unit",
	"PrepInfo",
	"auto_operator",
	"bandwidth",
	"reorder_rcm",
	"matrix_function",
	"aslinop",
	"is_linear_op",
	"is_valid_operator",
	"matmat",
	"quad_form",
	"gershgorin_interval",
]
