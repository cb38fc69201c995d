"""One-call posterior sampling over a model tree.

``sample_posterior(model, "log_posterior")`` wires together
:func:`make_log_prob`, chain initialization from the model's generator and
the chosen sampler, and returns the samples both as the sampler's result
and as constrained-space arrays keyed by tree path.
"""
from __future__ import annotations

import numpy as np
import torch

from . import chees as _chees
from . import hmc as _hmc
from . import nuts as _nuts
from .logprob import make_log_prob

_SAMPLERS = {"hmc": _hmc, "nuts": _nuts, "chees": _chees}


def sample_posterior(model, method, num_chains=8, num_samples=1000, num_warmup=500,
                     sampler="chees", collection="__default__", generator=None,
                     init_jitter=0.1, mesh=None, return_diagnostics=False, **kwargs):
    """Sample the posterior defined by a model objective.

    - method: objective returning the log density (name / method /
      Optimizer).
    - sampler: 'chees' (default), 'hmc', or 'nuts'.
    - collection: which Variables form theta. Defaults to the trainable tag
      ``Optimizer.compile`` uses (graph_key.VARIABLES), so variables a model
      keeps apart (the sparse families' frozen inducing points, tagged
      "inducing_z") stay frozen here too: sampling them would target an
      improper density (no prior on z). Pass None to sample every global.
    - generator: a torch.Generator on the model's device for the chain
      initialization and the sampler (default: the model's own).
    - mesh: a DeviceMesh whose ``chain`` dimension splits the chains;
      every rank draws the same initialization (the same generator seed
      on every rank) and gets every chain back.

    Returns (result, posterior): the sampler's NamedTuple and a dict of
    each tree path's constrained-space samples (numpy, leading axes
    [num_samples, num_chains]). Diagnostics (bulk ESS, split R-hat,
    divergences) are computed on the free-space samples and printed when
    ``[verbosity] hmc_verb`` >= 1; ``return_diagnostics=True`` also returns
    the summary dict.
    """
    if sampler not in _SAMPLERS:
        raise ValueError("sampler must be one of %s" % sorted(_SAMPLERS))
    if collection == "__default__":
        from ..core.param import graph_key

        collection = graph_key.VARIABLES
    flp = make_log_prob(model, method, collection)
    g = generator if generator is not None else model.generator
    init = flp.initial + init_jitter * torch.randn(
        (int(num_chains), flp.dim), generator=g, dtype=flp.initial.dtype,
        device=flp.initial.device,
    )
    res = _SAMPLERS[sampler].sample(
        flp.log_prob, init, g, num_samples=num_samples, num_warmup=num_warmup, mesh=mesh,
        **kwargs
    )
    flat = res.samples.detach().cpu().numpy()  # [S, C, dim]
    lookup = {v.path_to(model): v for v in model.get_variables()}
    posterior = {}
    off = 0
    for path, shape in zip(flp.paths, flp.shapes):
        size = int(np.prod(shape)) if len(shape) else 1
        free = flat[..., off:off + size].reshape(flat.shape[:2] + tuple(shape))
        posterior[path] = np.asarray(lookup[path].transform.forward(free))
        off += size

    from . import diagnostics

    summary = diagnostics.summarize(flat, accept_prob=res.accept_prob.detach().cpu().numpy())
    diagnostics.report(summary, prefix="[henbun %s]" % sampler)
    if return_diagnostics:
        return res, posterior, summary
    return res, posterior
