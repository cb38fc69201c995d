"""Amortized Bayesian GP-LVM: an unsupervised latent variable model with a
GP decoder.

    t_i ~ N(0, I)^{d_z}                 (latent coordinates, unobserved)
    f_d ~ GP(0, k)  for each of d_y outputs (shared kernel, sparse)
    y_i ~ N(F(t_i), var I)
    q(t_i) fed by an encoder from y_i     (amortized recognition network)
    q(u_d) whitened inducing posteriors   (layered n_layers=[d_y] axis)

The encoder-fed LOCAL machinery joined to the SparseGP decoder: a
GP-decoder VAE trained by minibatch SVI, Monte Carlo over both t and u.
The local KL is closed form and minibatch-scaled, the inducing KL global.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import densities, gp, nn, transforms, variationals
from ..core.param import MinibatchData, Variable, graph_key
from ..model import Model, AutoOptimize
from ._slab import condition_slab, packed_slab_conditioning


class GPLVM(Model):
    """Amortized sparse GP-LVM (Y [n, d_y] -> latents [n, d_z])."""

    def setUp(self, Y, d_z=1, num_inducing=16, hidden=32, q_local="diagonal"):
        n, d_y = np.shape(Y)
        self._d_y, self._d_z = int(d_y), int(d_z)
        self.y = MinibatchData(Y)
        self.n_data = n

        # recognition network: y_i -> feed slab of q(t_i)
        self.t = variationals.Normal(
            shape=[d_z], q_shape=q_local, collections=graph_key.LOCAL, analytic_kl=True,
        )
        self.encoder = nn.NeuralNet(
            [d_y, hidden, self.t.feed_size], neuron_types=nn.relu, stddev=0.3,
        )
        # packed (correlated) locals: identity bias and 0.1x factor scale
        # (models/_slab.py)
        if q_local == "fullrank_packed":
            self._slab_bias, self._slab_scale = packed_slab_conditioning(
                d_z, self.t.feed_size
            )
        else:
            self._slab_bias = None
            self._slab_scale = None

        # GP decoder over the latent space; inducing inputs where the N(0,I)
        # prior puts the latents
        m = int(num_inducing)
        rng = np.random.default_rng(0)
        if d_z == 1:
            z = np.linspace(-2.2, 2.2, m).reshape(-1, 1).astype(np.float32)
        else:
            z = rng.normal(size=(m, d_z)).astype(np.float32)
        self.gp = gp.SparseGP(gp.kernels.UnitRBF(), z)
        self.u = variationals.Normal(
            shape=[1, m], n_layers=[d_y], q_shape="fullrank", analytic_kl=True,
        )
        eye = np.eye(m, dtype=np.float32)
        self.u.q_sqrt = np.broadcast_to(eye, (d_y, m, m)).copy()
        self.k_var = Variable(shape=[1], transform=transforms.positive)
        self.var = Variable(shape=[1], transform=transforms.positive)

    def _decode(self, t):
        """One GP-decoder sample at latent coordinates t [B, d_z]: [B, d_y]."""
        u = torch.reshape(self.u, (self._d_y, -1))
        return (self.gp.samples(t, u, "diagonal") * torch.sqrt(self.k_var)).mT

    def _slab(self, y):
        return condition_slab(self.encoder(y), self._slab_bias, self._slab_scale)

    def _as_y(self, y):
        return torch.as_tensor(y, dtype=self.y.dtype, device=self.y.device)

    def latent_mean(self, y):
        """The encoder's posterior mean over latents for rows y [B, d_y]:
        [B, d_z], deterministic (the slab's first d_z slots are q_mu; LOCAL
        children pack name-sorted, q_mu before q_sqrt)."""
        return self._slab(self._as_y(y))[..., : self._d_z]

    def reconstruct(self, y):
        """One posterior reconstruction sample of rows y: encode, sample
        q(t), decode. Use with Model.draws for means and bands."""
        self.t = self._slab(self._as_y(y))  # feed
        return self._decode(self.t)

    @AutoOptimize()
    def ELBO(self):
        self.t = self._slab(self.y)  # feed: unpack the slab, sample q(t)
        t = self.t  # [B, d_z] reparameterized sample
        y_fit = self._decode(t)
        scale = self.n_data / y_fit.shape[0]
        log_lik = torch.sum(densities.gaussian(self.y, y_fit, self.var))
        # the local KL sums over the batch -> minibatch-scaled; the inducing
        # posterior's KL is global -> unscaled
        local_kl = self.KL(graph_key.LOCAL)
        global_kl = self.KL(graph_key.VARIABLES)
        return scale * (log_lik - local_kl) - global_kl


def make_curve_dataset(n=1000, noise=0.05, seed=0):
    """Observations on a smooth 1D curve embedded in 3D:
    y(t) = [sin(t), cos(t), t/2] + eps, t ~ U(-2, 2). The GP-LVM must
    recover t up to sign or a monotone reparameterization."""
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(-2.0, 2.0, size=n)).astype(np.float32)
    Y = np.stack([np.sin(t), np.cos(t), 0.5 * t], axis=1) + rng.normal(
        size=(n, 3)
    ).astype(np.float32) * noise
    return Y.astype(np.float32), t
