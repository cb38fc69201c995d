"""Prebuilt model families: GP regression and binary GP classification
(dense and inducing-point, by Laplace or EP evidence), multiclass
inducing-point classification by the softmax Laplace evidence,
variational and MAP linear models, amortized (encoder-fed) SVI regression,
Bayesian neural nets and the sparse variational GP families."""
from .gpr import GPR, GPRMarginal, SparseGPRobust, make_sine_dataset
from .linear import VariationalLinearModel, MAPLinearModel, make_linear_dataset
from .amortized import AmortizedRegression, make_synthetic_regression
from .bnn import BNN, VariationalBNN, make_bnn_dataset
from .svgp import (
    SVGPRegression,
    SVGPClassification,
    SVGPCount,
    SVGPMulticlass,
)
from .gpc import GPC, SparseGPC, SparseGPMulticlass
