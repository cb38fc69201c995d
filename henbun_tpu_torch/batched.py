"""Batched multi-model training: N independent model fits advanced by one
step loop.

N structurally-identical models (per-output, per-fold or per-restart fits)
have their parameter trees stacked on a new leading axis, and the
per-model objective runs over that axis under
``torch.func.vmap(..., randomness="different")``: each model draws its own
noise. The vmapped objectives are summed and one ``.backward()`` follows.
Inside the vmap, ``safe_cholesky`` and ``tri_solve`` see a batch of M
matrices through their ``vmap`` rules (``ops/linalg.py``), which is what
sends the fleet's factorizations and solves to the hand-written CUDA
kernels.

Because Adam is per-parameter, the stacked update IS N independent
optimizer runs, and the summed objective's gradient with respect to model
i's parameters is exactly model i's gradient.
"""
from __future__ import annotations

import numpy as np
import torch

from ._settings import settings
from .core import context as _ctx
from .model import Optimizer, _resolve_method


class BatchedOptimizer(Optimizer):
    """Train N structurally-identical models as one fleet.

    - models: Model instances with identical tree structure, identical
      data shapes and one device (different data VALUES are the point).
    - The recorded per-step objective is the SUM over models.
    - Inherits the training loop: chunks, nan-guard rollback, callbacks,
      StepMetrics, and both minibatch modes (rows drawn per model).
    - ``noise_source`` results are stacked: {path: [M, *shape]}.
    """

    def __init__(self, models, likelihood_method):
        if len(models) < 1:
            raise ValueError("need at least one model")
        super().__init__(models[0], _resolve_method(models[0], likelihood_method))
        self.models = list(models)

    def _models(self):
        return self.models

    # ------------------------------------------------------------ structure
    def _check_structure(self):
        def shapes(m):
            p = {k: tuple(v.shape) for k, v in m.param_dict().items()}
            d = {k: np.shape(v) for k, v in m.data_dict().items()}
            return p, d

        ref_p, ref_d = shapes(self.models[0])
        for i, m in enumerate(self.models[1:], 1):
            p, d = shapes(m)
            if p != ref_p or d != ref_d:
                raise ValueError(
                    "model %d does not match model 0's tree structure "
                    "(params %r vs %r; data %r vs %r)" % (i, p, ref_p, d, ref_d)
                )
            if m.device != self.models[0].device:
                raise ValueError(
                    "model %d is on %s, model 0 on %s"
                    % (i, m.device, self.models[0].device)
                )

    @staticmethod
    def _stack(dicts):
        return {k: torch.stack([d[k] for d in dicts]) for k in dicts[0]}

    # -------------------------------------------------------- Optimizer hooks
    def _prepare_models(self):
        if settings.verbosity.tf_compile_verb:
            print("(batched x%d)" % len(self.models))
        self._check_structure()
        for m in self.models:
            m.initialize()
            m.validate()
        sizes = {m._index.data_size for m in self.models}
        if len(sizes) > 1:
            raise ValueError(
                "batched minibatch training needs equal data sizes; got %r"
                % sorted(s for s in sizes if s is not None)
            )

    def _param_dicts(self):
        c = self.collection
        return (
            self._stack([m.param_dict(c) for m in self.models]),
            self._stack([m.param_dict(exclude=c) for m in self.models]),
        )

    def _data_args(self):
        return self._stack([m._gather_data() for m in self.models])

    def _objective(self, guards):
        model = self.model
        method = self.likelihood_method

        def core(trainable, frozen, d, generator, noise):
            def one_model(trainable_i, frozen_i, d_i, noise_i):
                params = dict(trainable_i)
                params.update(frozen_i)
                with _ctx.trace(model, params, d_i, generator, noise=noise_i) as ctx:
                    val = method(model)
                    diags = dict(ctx.diagnostics)
                    guards.update(ctx.diagnostic_guards)
                return val, diags

            vals, diags = torch.func.vmap(one_model, randomness="different")(
                trainable, frozen, d, noise or {}
            )
            # guard on the worst model of the fleet
            return torch.sum(vals), {k: torch.max(v) for k, v in diags.items()}

        return core

    def _commit_params(self, trainable):
        for i, m in enumerate(self.models):
            m.set_param_dict({k: v[i] for k, v in trainable.items()})

    def _row_axis(self):
        return 1
