"""Inference engines beyond SVI: the vectorized log density, HMC, the
iterative NUTS, ChEES-HMC and SMC (chains and particles batched in
lockstep on one device), the Laplace approximation (the scalar-likelihood
engine and the multiclass softmax engine) and expectation propagation."""
from . import logprob, hmc, nuts, chees, smc, api, diagnostics, laplace, ep
from .logprob import make_log_prob, FlatLogProb
from .api import sample_posterior
from .diagnostics import ess_bulk, split_rhat, effective_sample_size
from .laplace import laplace_whitened, LaplaceResult
from .ep import ep_gp, ep_latent_marginals, EPResult
