"""Prebuilt model families: GP regression and binary GP classification
(dense and inducing-point, by Laplace or EP evidence), multiclass
inducing-point classification by the softmax Laplace evidence,
mixture-of-experts GPR, variational and MAP linear models, amortized
(encoder-fed) SVI regression, Bayesian neural nets, the sparse variational
GP families, heteroscedastic and multi-output (LMC) regression (exact-gram
and sparse), doubly-stochastic deep GPs and the amortized GP-LVM."""
from .gpr import GPR, GPRMarginal, SparseGPRobust, make_sine_dataset
from .expert_gpr import ExpertGPR, make_expert_dataset
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
from .hetero import HeteroscedasticGPR, HeteroSVGP, make_hetero_dataset
from .multioutput import MultiOutputGPR, MultiOutputSVGP, make_multioutput_dataset
from .deepgp import DeepGPRegression, make_step_dataset
from .gplvm import GPLVM, make_curve_dataset
