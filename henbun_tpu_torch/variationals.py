"""Variational posteriors with reparameterized single-sample KL estimation.

``Variational`` (diagonal / fullrank / fullrank_packed Gaussian q) and the
predefined ``Normal``, ``Gaussian``, ``OffsetGaussian`` and ``Beta``.

Reparameterization noise ``u`` comes from the trace context
(:meth:`~henbun_tpu_torch.core.context.TraceContext.node_noise`), once per
evaluation and node path, and the sample is cached in the context so that
``KL()`` uses the same noise as the sample.
"""
from __future__ import annotations

import numpy as np
import torch

from ._settings import settings, np_float
from . import densities, transforms, priors
from .core import context as _ctx
from .core.param import (
    Variable, graph_key, Parameterized, _in_collections, _tree_device,
)
from .ops.linalg import clip, fill_triangular, fill_triangular_diag_indices


def _packed_diag_indices(s, device):
    """Indices of the diagonal within the packed lower triangle
    (:func:`ops.linalg.fill_triangular`'s layout, not row-major)."""
    return torch.as_tensor(fill_triangular_diag_indices(s), device=device)


def _float_type():
    return settings.dtypes.float_type


class Variational(Parameterized):
    """Multivariate-Gaussian variational posterior over a flattened `shape`.

    q covariance:
      'diagonal'        — log-std stored in q_sqrt;
      'fullrank'        — dense [size, size] matrix, lower triangle used;
      'fullrank_packed' — the lower triangle packed into size*(size+1)/2
                          free params.
    """

    def __init__(
        self,
        shape,
        n_layers=[],
        n_batch=None,
        q_shape="diagonal",
        mean=0.0,
        stddev=1.0,
        prior=None,
        transform=None,
        collections=None,
    ):
        Parameterized.__init__(self)
        collections = collections if collections is not None else [graph_key.VARIABLES]
        self._shape = [shape] if isinstance(shape, int) else list(shape)
        self.n_layers = [n_layers] if isinstance(n_layers, int) else list(n_layers)
        self.n_batch = n_batch
        self.size = int(np.prod(self._shape))
        self.collections = collections
        if q_shape not in ("diagonal", "fullrank", "fullrank_packed"):
            raise ValueError("unknown q_shape %r" % (q_shape,))
        self.q_shape = q_shape
        self.q_mu = Variable(
            self.size,
            n_layers=n_layers,
            n_batch=self.n_batch,
            mean=mean,
            stddev=0.1 * stddev,
            collections=collections,
        )
        if self.q_shape == "diagonal":
            # log(q_sqrt) is stored — a manual positivity transform
            self.q_sqrt = Variable(
                self.size,
                n_layers=n_layers,
                n_batch=self.n_batch,
                mean=np.log(stddev),
                stddev=0.1,
                collections=collections,
            )
        elif self.q_shape == "fullrank_packed":
            # diagonal entries init ~stddev, off-diagonal ~0
            tri_init = np.zeros(self.size * (self.size + 1) // 2, np_float())
            tri_init[fill_triangular_diag_indices(self.size)] = stddev
            self.q_sqrt = Variable(
                self.size * (self.size + 1) // 2,
                n_layers=n_layers,
                n_batch=self.n_batch,
                mean=0.0,
                stddev=0.1 * stddev,
                collections=collections,
            )
            if collections not in graph_key.not_parameters:
                self.q_sqrt.set_free_value(
                    np.asarray(self.q_sqrt.free_value) + tri_init
                )
        else:
            self.q_sqrt = Variable(
                [self.size, self.size],
                n_layers=n_layers,
                n_batch=self.n_batch,
                mean=stddev,
                stddev=0.1 * stddev,
                collections=collections,
            )
        self.transform = transform if transform is not None else transforms.Identity()
        self.prior = prior

    # --- sampling -----------------------------------------------------------
    def _draw(self, ctx, path, sample_shape):
        u = ctx.node_noise(path, sample_shape, _float_type())
        raw = self._sample(u)
        state = {"u": u, "raw": raw, "transformed": self.transform.tf_forward(raw)}
        ctx.samples[path] = state
        return state

    def _state(self):
        """The per-evaluation sample state {u, raw, transformed}; drawn
        lazily for non-LOCAL nodes (LOCAL nodes get theirs in feed())."""
        ctx = _ctx.current()
        if ctx is None:
            raise RuntimeError(
                "Variational samples only exist inside a traced objective."
            )
        path = self.path_to(ctx.root)
        if path in ctx.samples:
            return ctx.samples[path]
        if self.collections is graph_key.LOCAL:
            raise ValueError(
                "local variational parameter " + self.long_name + " is not fed."
            )
        if self.n_batch is None:
            sample_shape = tuple(self.n_layers) + (self.size,)
        else:
            sample_shape = tuple(self.n_layers) + (self.n_batch, self.size)
        return self._draw(ctx, path, sample_shape)

    def _sample(self, u):
        """Reparameterized draw from q given i.i.d. noise u."""
        if self.q_shape == "diagonal":
            return self.q_mu + torch.exp(self.q_sqrt) * u
        if self.q_shape == "fullrank_packed":
            sqrt = fill_triangular(self.q_sqrt, self.size)
        else:
            sqrt = torch.tril(self.q_sqrt)
        return self.q_mu + torch.einsum("...ij,...j->...i", sqrt, u)

    def tensor(self):
        """Inside a trace this node *is* a posterior sample, reshaped to
        [*n_layers, (N,) *shape] and clipped."""
        s = self._state()
        if self.collections is not graph_key.LOCAL and self.n_batch is None:
            return clip(
                torch.reshape(
                    s["transformed"], tuple(self.n_layers) + tuple(self._shape)
                )
            )
        return clip(
            torch.reshape(
                s["transformed"], tuple(self.n_layers) + (-1,) + tuple(self._shape)
            )
        )

    def feed(self, x):
        """LOCAL case: unpack the encoder slab into q_mu/q_sqrt, then draw
        fresh noise with the fed batch size."""
        Parameterized.feed(self, x)
        if self.collections is graph_key.LOCAL:
            ctx = _ctx.current()
            path = self.path_to(ctx.root)
            self._draw(ctx, path, tuple(self.n_layers) + (x.shape[-2], self.size))

    # --- KL -----------------------------------------------------------------
    @property
    def logdet(self):
        """Log-determinant of the posterior covariance's square-root factor
        per element."""
        if self.q_shape == "diagonal":
            return 2.0 * self.q_sqrt
        # epsilon keeps the barrier (and its gradient) finite when an Adam
        # step pushes a diagonal entry across zero
        if self.q_shape == "fullrank_packed":
            sq = self.q_sqrt
            diag = sq[..., _packed_diag_indices(self.size, sq.device)]
        else:
            diag = torch.diagonal(self.q_sqrt, dim1=-2, dim2=-1)
        return torch.log(torch.square(diag) + 1e-20)

    def KL(self, collection=None):
        if collection is None or _in_collections(collection, self.collections):
            return self._KL()
        return torch.zeros([], dtype=_float_type(), device=_tree_device(self))

    def _KL(self):
        """Single-sample estimate of KL[q || p]."""
        s = self._state()
        kl = -0.5 * torch.sum(np.log(2.0 * np.pi) + self.logdet + torch.square(s["u"]))
        if self.prior is not None:
            kl = kl - torch.sum(self.prior.logp(s["transformed"]))
            kl = kl - torch.sum(self.transform.tf_log_jacobian(s["raw"]))
        return kl


# --- predefined variational parameters --------------------------------------


class Normal(Variational):
    """Variational parameter with N(0,1) prior and identity transform; its
    _KL is the reduced single-sample estimate.

    analytic_kl=True replaces the estimator with the exact Gaussian KL
    0.5 (|mu|^2 + tr Sigma - m - logdet Sigma), valid because this family
    pins the prior to N(0, I) with an identity transform.
    """

    def __init__(
        self,
        shape,
        n_layers=[],
        n_batch=None,
        q_shape="diagonal",
        mean=0.0,
        stddev=1.0,
        collections=None,
        analytic_kl=False,
    ):
        Variational.__init__(
            self,
            shape,
            q_shape=q_shape,
            n_layers=n_layers,
            n_batch=n_batch,
            mean=mean,
            stddev=stddev,
            prior=priors.Normal(),
            transform=transforms.Identity(),
            collections=collections,
        )
        self.analytic_kl = bool(analytic_kl)

    def _KL(self):
        if self.analytic_kl:
            mu = self.q_mu
            sq = self.q_sqrt
            if self.q_shape == "diagonal":
                tr = torch.sum(torch.exp(2.0 * sq))
            elif self.q_shape == "fullrank_packed":
                # every packed entry is a factor entry: tr LL^T = sum L_ij^2
                tr = torch.sum(torch.square(sq))
            else:
                tr = torch.sum(torch.square(torch.tril(sq)))
            total = int(np.prod(mu.shape))
            return 0.5 * (
                torch.sum(torch.square(mu)) + tr - total - torch.sum(self.logdet)
            )
        s = self._state()
        return -0.5 * torch.sum(
            self.logdet + torch.square(s["u"]) - torch.square(s["raw"])
        )


class Gaussian(Normal):
    """Normal posterior scaled by a trainable positive `scale` Variable;
    initialization splits mean/stddev between the scale and q."""

    def __init__(
        self,
        shape,
        n_layers=[],
        n_batch=None,
        q_shape="diagonal",
        mean=0.0,
        stddev=1.0,
        collections=None,
        scale_shape=None,
        scale_n_layers=None,
        analytic_kl=False,
    ):
        if np.abs(mean) < stddev:
            scale_mean = stddev
            q_mean = mean / stddev
            q_std = 1.0
        else:
            scale_mean = np.abs(mean)
            q_mean = 1.0
            q_std = stddev / np.abs(mean)
        Variational.__init__(
            self,
            shape,
            q_shape=q_shape,
            n_layers=n_layers,
            n_batch=n_batch,
            mean=q_mean,
            stddev=q_std,
            prior=priors.Normal(),
            transform=transforms.Identity(),
            collections=collections,
        )
        self.analytic_kl = bool(analytic_kl)
        scale_shape = scale_shape or [1 for _ in self._shape]
        scale_layer = scale_n_layers or [1 for _ in self.n_layers]
        self.scale = Variable(
            scale_shape,
            n_layers=scale_layer,
            n_batch=n_batch,
            mean=scale_mean,
            stddev=0.1 * scale_mean,
            transform=transforms.positive,
            collections=collections,
        )

    def tensor(self):
        return self.scale * Normal.tensor(self)


class OffsetGaussian(Gaussian):
    """Gaussian posterior plus a trainable offset."""

    def __init__(
        self,
        shape,
        n_layers=[],
        n_batch=None,
        q_shape="diagonal",
        mean=0.0,
        stddev=1.0,
        collections=None,
        scale_shape=None,
        scale_n_layers=None,
        analytic_kl=False,
    ):
        Gaussian.__init__(
            self,
            shape=shape,
            n_layers=n_layers,
            n_batch=n_batch,
            q_shape=q_shape,
            mean=0.0,
            stddev=stddev,
            collections=collections,
            scale_shape=scale_shape,
            scale_n_layers=scale_n_layers,
            analytic_kl=analytic_kl,
        )
        offset_shape = scale_shape or [1 for _ in self._shape]
        offset_layer = scale_n_layers or [1 for _ in self.n_layers]
        self.offset = Variable(
            offset_shape,
            n_layers=offset_layer,
            n_batch=n_batch,
            mean=mean,
            stddev=0.1 * mean,
            collections=collections,
        )

    def tensor(self):
        return Gaussian.tensor(self) + self.offset


class Beta(Variational):
    """Posterior mapped to (0, 1) by a Logistic transform, with a Beta prior
    whose ``alpha`` and ``beta`` are trainable positive Variables. It is
    Gaussian in free space, so the natural gradient steps its
    (q_mu, q_sqrt) pair; ``alpha`` and ``beta`` go to the other optimizer."""

    def __init__(
        self,
        shape,
        n_layers=[],
        n_batch=None,
        q_shape="diagonal",
        mean=0.0,
        stddev=1.0,
        collections=None,
        scale_shape=None,
        scale_n_layers=None,
    ):
        Variational.__init__(
            self,
            shape,
            q_shape=q_shape,
            n_layers=n_layers,
            n_batch=n_batch,
            mean=mean,
            stddev=stddev,
            transform=transforms.Logistic(),
            collections=collections,
        )
        scale_shape = scale_shape or [1 for _ in self._shape]
        scale_layer = scale_n_layers or [1 for _ in self.n_layers]
        self.alpha = Variable(
            scale_shape,
            n_layers=scale_layer,
            n_batch=n_batch,
            mean=1.0,
            stddev=0.1,
            transform=transforms.positive,
            collections=collections,
        )
        self.beta = Variable(
            scale_shape,
            n_layers=scale_layer,
            n_batch=n_batch,
            mean=1.0,
            stddev=0.1,
            transform=transforms.positive,
            collections=collections,
        )

    def _KL(self):
        s = self._state()
        kl = -0.5 * torch.sum(np.log(2.0 * np.pi) + self.logdet + torch.square(s["u"]))
        kl = kl - torch.sum(densities.beta(self.alpha, self.beta, s["transformed"]))
        return kl - torch.sum(self.transform.tf_log_jacobian(s["raw"]))
