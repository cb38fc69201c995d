"""GP kernels: ``Kern``, ``UnitStationary`` (trainable positive
lengthscales, batched square/euclid distances, jittered Cholesky), the RBF,
Matern, periodic and linear kernels, and the ``Add`` / ``Prod``
combinators.

The kernel matrix is built from one batched matmul at full float32
precision (``matmul_hp``): TF32 upstream of a Cholesky loses enough digits
to break the factorization. Batched [N, n, d] inputs map to a single
batched matmul. Its gradient, and a gram evaluated without gradients,
come from the inputs' differences instead (``square_dist``).
"""
from __future__ import annotations

import numpy as np
import torch

from .. import transforms
from .._settings import settings
from ..core.param import Variable, Parameterized, ParamList, graph_key
from ..variationals import Variational
from ..ops.linalg import matmul_hp, safe_cholesky


def _float_type():
    return settings.dtypes.float_type


def cholesky_jitter(n):
    """The base jitter of an n x n gram's factorization (Kern.Cholesky)."""
    return settings.numerics.jitter_level * max(1.0, n / 96.0)


def _square_dist(a, b):
    """|a_i|^2 + |b_j|^2 - 2 a_i.b_j: [..., n, d], [..., n2, d] -> [..., n, n2]."""
    return (-2 * matmul_hp(a, b.mT) + torch.sum(torch.square(a), -1)[..., :, None]
            + torch.sum(torch.square(b), -1)[..., None, :])


class _SquareDist(torch.autograd.Function):
    """The matmul form's value with the gradient of the differences:
    abar_i = 2 sum_j Sbar_ij (a_i - b_j), bbar_j = -2 sum_i Sbar_ij (a_i - b_j).

    Autograd through the matmul form takes each of these as a difference of
    two large halves (2 rowsum(Sbar) a_i - 2 Sbar b), which float32 cancels
    wherever Sbar is large and of both signs, as it is behind the Cholesky
    of an ill-conditioned gram. With the shared-kernel MultiOutputGPR
    ELBO_mc's gram cotangent (n = 12, largest entry 8.9e3), torch's
    autograd of the matmul form lands 3.1e-3 from float64 on the
    lengthscale, XLA's compiled gradient of the same form 6.2e-5, the
    differences 1.4e-4. The backward builds the [..., n, n2, d] difference
    tensor."""

    generate_vmap_rule = True

    @staticmethod
    def forward(a, b):
        return _square_dist(a, b)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, Sbar):
        a, b = ctx.saved_tensors
        diff = a[..., :, None, :] - b[..., None, :, :]
        abar = 2 * torch.sum(Sbar[..., None] * diff, -2)
        bbar = -2 * torch.sum(Sbar[..., None] * diff, -3)
        return abar, bbar


class Kern(Parameterized):
    """The basic kernel class; K, Kdiag and Cholesky show as named ranges
    in a profiler trace.

    active_dims: optional static sequence of input-column indices this
    kernel sees (None = all)."""

    def __init__(self, active_dims=None):
        Parameterized.__init__(self)
        self.scoped_keys.extend(["K", "Kdiag", "Cholesky"])
        self._active_dims = (
            None if active_dims is None else tuple(int(i) for i in active_dims)
        )

    def _slice(self, X):
        if self._active_dims is None or X is None:
            return X
        return X[..., list(self._active_dims)]

    def Cholesky(self, X):
        """Lower Cholesky factor of K(X) + jitter*I; batched if X is
        [N, n, d]. Uses the NaN-retry escalating jitter of
        :func:`safe_cholesky`, with the base jitter scaled by
        max(1, n / 96): float32 factorization error grows with n, and the
        gradient NaNs before the forward pass does."""
        return safe_cholesky(self.K(X), cholesky_jitter(X.shape[-2]))


class UnitStationary(Kern):
    def __init__(self, lengthscales=np.ones(1), n_batch=None, collections=None,
                 active_dims=None):
        """lengthscales: scalar/1d np.array initial value, or an existing
        Variable/Variational node. With active_dims, lengthscales apply to
        the SLICED columns."""
        Kern.__init__(self, active_dims)
        collections = collections if collections is not None else [graph_key.VARIABLES]
        if isinstance(lengthscales, np.ndarray):
            self.lengthscales = Variable(
                lengthscales.shape,
                transform=transforms.positive,
                collections=collections,
            )
            self.lengthscales = lengthscales  # deferred assign of initial values
        elif isinstance(lengthscales, (Variable, Variational)):
            self.lengthscales = lengthscales
        else:
            raise TypeError
        self.scoped_keys.extend(["square_dist", "euclid_dist"])

    def square_dist(self, X, X2=None):
        """Squared distance matrix in lengthscale units.

        X: [n, d] (returns [n, n2]) or batched [N, n, d] (returns
        [N, n, n2]). With gradients enabled, the JAX package's matmul form
        |x|^2 + |x2|^2 - 2 x.x2 (one batched matmul at full float32
        precision), so that training follows the JAX package's float32
        values, with the gradient of the differences (:class:`_SquareDist`).
        Without gradients (prediction, evaluation, an exported program) a
        gram (X2 None), which a Cholesky factors next, comes from the
        differences: the matmul form cancels at close points, and at a
        fitted per-latent MultiOutputGPR (n = 80) put predict_f 1.9e-4 to
        2.6e-4 of the scale from float64, the differences 3.0e-5."""
        X, X2 = self._slice(X), self._slice(X2)
        Xeff = X / self.lengthscales
        X2eff = Xeff if X2 is None else X2 / self.lengthscales
        if torch.is_grad_enabled():
            return _SquareDist.apply(Xeff, X2eff)
        if X2 is None:
            return torch.sum(torch.square(Xeff[..., :, None, :] - Xeff[..., None, :, :]), -1)
        return _square_dist(Xeff, X2eff)

    def euclid_dist(self, X, X2):
        """Euclidean distance matrix in lengthscale units, from the
        differences: sqrt(sum_k (x_ik - x2_jk)^2 + 1e-12).

        The matmul form of :meth:`square_dist` leaves float32 cancellation
        noise on the diagonal, where d sqrt(r^2 + 1e-12) / d r^2 is 5e5, and
        Matern-1/2's exp(-r) keeps a slope of -1 at r = 0: that noise then
        decides the lengthscale gradient. The differences are exactly zero
        there, and so is their gradient. (A departure from the JAX package,
        which takes the matmul form.) It builds the [..., n, n2, d]
        difference tensor: 64 MB at n = n2 = 4096, d = 1."""
        X = self._slice(X)
        X2 = X if X2 is None else self._slice(X2)
        Xeff = X / self.lengthscales
        X2eff = X2 / self.lengthscales
        diff = Xeff[..., :, None, :] - X2eff[..., None, :, :]
        return torch.sqrt(torch.sum(torch.square(diff), -1) + 1e-12)

    def Kdiag(self, X):
        return torch.ones(X.shape[:-1], dtype=_float_type(), device=X.device)


class UnitRBF(UnitStationary):
    """Unit-variance RBF: K(x,x2) = exp(-(x-x2)^2 / (2 l^2))."""

    def K(self, X, X2=None):
        return torch.exp(-self.square_dist(X, X2) / 2)


class UnitMatern12(UnitStationary):
    """Unit-variance Matern-1/2: K = exp(-r), r the lengthscale-scaled
    euclidean distance."""

    def K(self, X, X2=None):
        return torch.exp(-self.euclid_dist(X, X2))


class UnitMatern32(UnitStationary):
    """Unit-variance Matern-3/2: K = (1 + sqrt(3) r) exp(-sqrt(3) r)."""

    def K(self, X, X2=None):
        r = self.euclid_dist(X, X2) * np.sqrt(3.0)
        return (1.0 + r) * torch.exp(-r)


class UnitMatern52(UnitStationary):
    """Unit-variance Matern-5/2: K = (1 + sqrt(5) r + 5 r^2/3) exp(-sqrt(5) r)."""

    def K(self, X, X2=None):
        r = self.euclid_dist(X, X2) * np.sqrt(5.0)
        return (1.0 + r + torch.square(r) / 3.0) * torch.exp(-r)


class UnitPeriodic(UnitStationary):
    """Unit-variance periodic kernel (MacKay):
    K = exp(-0.5 * sum_d (2 sin(pi (x_d - x2_d) / period) / l_d)^2), with a
    trainable positive scalar `period`."""

    def __init__(self, lengthscales=np.ones(1), period=1.0, n_batch=None,
                 collections=None, active_dims=None):
        UnitStationary.__init__(self, lengthscales, n_batch, collections,
                                active_dims)
        cols = collections if collections is not None else [graph_key.VARIABLES]
        self.period = Variable(
            [1], transform=transforms.positive, collections=cols
        )
        self.period = np.asarray([period], dtype=np.float64)

    def K(self, X, X2=None):
        X = self._slice(X)
        X2 = X if X2 is None else self._slice(X2)
        d = X[..., :, None, :] - X2[..., None, :, :]
        s = 2.0 * torch.sin(np.pi * d / self.period) / self.lengthscales
        return torch.exp(-0.5 * torch.sum(torch.square(s), -1))


class UnitLinear(Kern):
    """Dot-product kernel K = (X/l) (X2/l)^T; Kdiag is the row norm."""

    def __init__(self, lengthscales=np.ones(1), collections=None,
                 active_dims=None):
        Kern.__init__(self, active_dims)
        cols = collections if collections is not None else [graph_key.VARIABLES]
        if isinstance(lengthscales, np.ndarray):
            self.lengthscales = Variable(
                lengthscales.shape, transform=transforms.positive,
                collections=cols,
            )
            self.lengthscales = lengthscales
        elif isinstance(lengthscales, (Variable, Variational)):
            self.lengthscales = lengthscales
        else:
            raise TypeError

    def K(self, X, X2=None):
        Xeff = self._slice(X) / self.lengthscales
        X2eff = Xeff if X2 is None else self._slice(X2) / self.lengthscales
        return matmul_hp(Xeff, X2eff.mT)

    def Kdiag(self, X):
        return torch.sum(torch.square(self._slice(X) / self.lengthscales), -1)


class Combination(Kern):
    """Base for kernel arithmetic; children live in a ParamList so each
    summand's parameters stay independently trainable."""

    def __init__(self, kern_list):
        Kern.__init__(self)
        self.kern_list = ParamList(list(kern_list))

    def _terms(self, X, X2):
        return [self.kern_list[i].K(X, X2) for i in range(len(self.kern_list))]

    def _diag_terms(self, X):
        return [self.kern_list[i].Kdiag(X) for i in range(len(self.kern_list))]


class Add(Combination):
    """K = sum of child kernels."""

    def K(self, X, X2=None):
        return sum(self._terms(X, X2))

    def Kdiag(self, X):
        return sum(self._diag_terms(X))


class Prod(Combination):
    """K = elementwise product of child kernels."""

    def K(self, X, X2=None):
        out = None
        for t in self._terms(X, X2):
            out = t if out is None else out * t
        return out

    def Kdiag(self, X):
        out = None
        for t in self._diag_terms(X):
            out = t if out is None else out * t
        return out


class UnitCsymRBF(UnitStationary):
    """Cylindrically-symmetric RBF: K(x,x2) = rbf(x,x2) + rbf(x,-x2)."""

    def K(self, X, X2=None):
        if X2 is None:
            X2 = X
        return torch.exp(-self.square_dist(X, X2) / 2) + torch.exp(
            -self.square_dist(X, -X2) / 2
        )

    def Kdiag(self, X):
        Xeff = self._slice(X) / self.lengthscales
        Xs = torch.sum(torch.square(Xeff), -1)
        return torch.ones_like(Xs) + torch.exp(-2 * Xs)
