"""Amortized stochastic VI, the framework's flagship scale workload
(BASELINE.json config 3: encoder -> local variational parameters, minibatch
SVI on a synthetic 1e6-point regression).

Per-datapoint latent variables whose variational parameters are not stored
but fed by an encoder network, so the model's state is O(globals) and
training is minibatch SGD. A step runs eagerly on the device: the minibatch
gather, the encoder, the slab unpack, the reparameterized sample, the
decoder, the ELBO, its gradient and the optimizer's update.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import densities, nn, transforms, variationals
from ..core.param import MinibatchData, Variable, graph_key
from ..model import Model, AutoOptimize
from ._slab import condition_slab, packed_slab_conditioning


class AmortizedRegression(Model):
    """VAE-style heteroscedastic regression with a per-datapoint latent:

        z_i ~ N(0, 1)^d_z          (prior)
        y_i ~ N(decoder(x_i, z_i), var)
        q(z_i) = Normal(mu_i, sig_i) with (mu_i, log sig_i) = encoder(x_i, y_i)

    The local posterior q(z) is a LOCAL ``variationals.Normal`` fed by the
    encoder slab (assigning the slab to ``self.z`` inside the objective
    feeds it).
    """

    def setUp(self, X, Y, d_z=4, hidden=64, analytic_kl=True,
              q_local="diagonal"):
        self.x = MinibatchData(X)
        self.y = MinibatchData(Y)
        self.n_data = X.shape[0]
        d_x = X.shape[1]
        # analytic_kl: the local KL in closed form from the fed slab;
        # q_local: 'diagonal' or 'fullrank_packed' (correlated locals from a
        # slab of d_z + d_z(d_z+1)/2 columns)
        self.z = variationals.Normal(
            shape=[d_z], q_shape=q_local, collections=graph_key.LOCAL,
            analytic_kl=analytic_kl,
        )
        # packed locals: identity bias and 0.1x factor scale (models/_slab.py)
        if q_local == "fullrank_packed":
            self._slab_bias, self._slab_scale = packed_slab_conditioning(
                d_z, self.z.feed_size
            )
        else:
            self._slab_bias = None
            self._slab_scale = None
        # the encoder emits the feed slab [N, feed_size]; a small init
        # stddev, since its raw output feeds log-sigma of the local posterior
        self.encoder = nn.NeuralNet(
            [d_x + 1, hidden, self.z.feed_size], neuron_types=nn.relu, stddev=0.3,
        )
        self.decoder = nn.NeuralNet(
            [d_x + d_z, hidden, 1], neuron_types=nn.relu, stddev=0.3
        )
        self.var = Variable(shape=[1], transform=transforms.positive)

    @AutoOptimize()
    def ELBO(self):
        xy = torch.cat([self.x, self.y], dim=-1)
        slab = condition_slab(self.encoder(xy), self._slab_bias, self._slab_scale)
        self.z = slab                      # feed: unpack the slab and sample
        z = self.z                         # [N, d_z] posterior sample
        xz = torch.cat([self.x, z], dim=-1)
        y_fit = self.decoder(xz)
        batch = xy.shape[0]
        # the likelihood and the local KL both sum over the batch: scale to
        # the full data set for unbiased global gradients
        scale = self.n_data / batch
        log_lik = torch.sum(densities.gaussian(self.y, y_fit, self.var))
        return scale * (log_lik - self.KL())


def make_synthetic_regression(n=1_000_000, d_x=8, seed=0):
    """Synthetic nonlinear heteroscedastic regression at the north-star size."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d_x)).astype(np.float32)
    w = rng.normal(size=(d_x,)).astype(np.float32)
    f = np.tanh(X @ w) + 0.3 * np.sin(2.0 * X[:, 0])
    noise = 0.1 + 0.2 * (1 + np.tanh(X[:, 1]))
    Y = (f + rng.normal(size=n) * noise).astype(np.float32)[:, None]
    return X, Y
