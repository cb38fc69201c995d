"""Inference engines. This slice carries the Laplace approximation
(``laplace``): ``laplace_whitened`` and its ``LaplaceResult``."""
from . import laplace
from .laplace import LaplaceResult, laplace_whitened
