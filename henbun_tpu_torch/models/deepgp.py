"""Doubly-stochastic Deep GP regression (arbitrary depth).

A composition of sparse GP layers trained by reparameterized minibatch
SVI: each layer carries its own whitened inducing posterior q(u_l), one
function sample propagates THROUGH the layers per evaluation (each layer's
correction noise is a ``"sparse_gp_diag#<l>"`` draw of
``SparseGP.samples``), and

    ELBO = N/|B| sum_i E_q[log N(y_i | f_L(...f_1(x_i)), var)] - sum_l KL(u_l).

Each hidden layer's width is a leading ``n_layers=[width]`` axis on its
variational node. Every hidden layer gets the identity-padded, fixed
linear mean function (without it the zero-mean prior over h wipes out the
input ordering at initialization); the output layer is zero-mean. Layer
l+1's inducing inputs start on the mean-function image of layer l's.

Layers live in a ParamList of per-layer Parameterized nodes
(``model.layers[l].gp / .u / .k_var``), so KL aggregation, collections,
checkpoint paths and the natural gradient's pairing apply per layer.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import densities, gp, transforms, variationals
from ..core import context as _ctx
from ..core.param import MinibatchData, Parameterized, ParamList, Variable
from ..model import Model, AutoOptimize
from .svgp import _quantile_z


class DeepGPRegression(Model):
    """Deep GP of ``depth`` SparseGP layers: x -> h_1 -> ... -> f -> y.

    depth=2 (default) is the classic two-layer DGP; any depth >= 1 works
    (depth=1 is a zero-mean SVGP). Hidden widths are ``d_hidden`` (default:
    the input dimension); the output layer is 1-D.
    """

    def setUp(self, X, Y, num_inducing=32, d_hidden=None, q_shape="fullrank",
              depth=2):
        n, d_in = np.shape(X)
        depth = int(depth)
        if depth < 1:
            raise ValueError("depth must be >= 1, got %d" % depth)
        d_hidden = int(d_hidden) if d_hidden is not None else d_in
        self._widths = [d_hidden] * (depth - 1) + [1]
        self.x = MinibatchData(X)
        self.y = MinibatchData(Y)
        self.n_data = n
        m = int(num_inducing)

        z = _quantile_z(X, m)
        eye_m = np.eye(m, dtype=np.float32)
        layers = []
        mean_Ws = []
        in_dim = d_in
        for i, width in enumerate(self._widths):
            lay = Parameterized()
            lay.gp = gp.SparseGP(gp.kernels.UnitRBF(), z)
            lay.u = variationals.Normal(
                shape=[1, m], n_layers=[width], q_shape=q_shape, analytic_kl=True,
            )
            if q_shape == "fullrank":
                # prior-matched identity init (as SVGPRegression's)
                lay.u.q_sqrt = np.broadcast_to(eye_m, (width, m, m)).copy()
            lay.k_var = Variable(shape=[1], transform=transforms.positive)
            if i < len(self._widths) - 1:
                # identity-padded fixed skip for the hidden layer; the next
                # layer's inducing inputs start on its image of z
                W = np.zeros((in_dim, width), np.float32)
                k = min(in_dim, width)
                W[:k, :k] = np.eye(k, dtype=np.float32)
                mean_Ws.append(W)
                z = (z @ W).astype(np.float32)
            else:
                mean_Ws.append(None)  # zero-mean output layer
            in_dim = width
            layers.append(lay)
        self.layers = ParamList(layers)
        self._mean_Ws = mean_Ws
        self._mean_W_cache = {}
        self.var = Variable(shape=[1], transform=transforms.positive)

    def _propagate(self, x, upto=None):
        """One posterior sample through layers [0, upto): [B, width]."""
        h = x
        stop = len(self._widths) if upto is None else int(upto)
        for i in range(stop):
            lay = self.layers[i]
            u = torch.reshape(lay.u, (self._widths[i], -1))  # [width, m]
            out = (lay.gp.samples(h, u, "diagonal") * torch.sqrt(lay.k_var)).mT  # [B, width]
            W = self._mean_W(i, h)
            if W is not None:
                out = out + h @ W
            h = out
        return h

    def _mean_W(self, i, h):
        """Layer i's fixed skip on h's device and float type, copied there
        once (a host copy at every evaluation would synchronize)."""
        W = self._mean_Ws[i]
        if W is None:
            return None
        key = (i, h.device, h.dtype)
        if key not in self._mean_W_cache:
            self._mean_W_cache[key] = torch.as_tensor(W, dtype=h.dtype, device=h.device)
        return self._mean_W_cache[key]

    def _as_x(self, x):
        return torch.as_tensor(x, dtype=self.x.dtype, device=self.x.device)

    def hidden(self, x):
        """One posterior sample of the FIRST hidden layer at x:
        [B, d_hidden] (the warp the composition learns)."""
        return self._propagate(self._as_x(x), upto=1)

    def f(self, x):
        """One posterior sample of the output function at x: [B, 1]."""
        return self._propagate(x)

    def predict_f(self, x_new):
        """Posterior function samples at new inputs (use with Model.draws)."""
        return self.f(self._as_x(x_new))

    def predict_y(self, x_new):
        """Predictive samples of y: f plus observation noise, drawn from the
        model's generator (injection path ``"deepgp_predict_y#0"``)."""
        f = self.predict_f(x_new)
        eps = _ctx.current().tagged_noise("deepgp_predict_y", f.shape, f.dtype)
        return f + torch.sqrt(self.var) * eps

    @AutoOptimize()
    def ELBO(self):
        f = self.f(self.x)  # [B, 1]
        scale = self.n_data / f.shape[0]
        return scale * torch.sum(densities.gaussian(self.y, f, self.var)) - self.KL()


def make_step_dataset(n=400, noise=0.05, seed=0):
    """A sharp step, y = 1[x > 0] + eps: a stationary single-layer GP must
    trade off the jump against the flat regions; the composition warps x
    instead."""
    rng = np.random.default_rng(seed)
    X = np.sort(rng.uniform(-1, 1, size=(n, 1))).astype(np.float32)
    Y = (X > 0).astype(np.float32) + rng.normal(size=(n, 1)).astype(np.float32) * noise
    return X, Y
