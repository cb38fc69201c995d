"""Inference engines. This slice carries the Laplace approximation
(``laplace``: ``laplace_whitened`` and its ``LaplaceResult``) and
expectation propagation (``ep``: ``ep_gp``, ``ep_gp_projected``, the
predictive marginals and ``EPResult``)."""
from . import laplace, ep
from .laplace import LaplaceResult, laplace_whitened
from .ep import ep_gp, ep_latent_marginals, EPResult
