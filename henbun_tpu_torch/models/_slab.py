"""Encoder-slab conditioning for packed fullrank LOCAL posteriors.

A ``fullrank_packed`` local's slab feeds factor entries directly (no log
transform, unlike the diagonal family), so a fresh encoder's ~0 outputs
start every local near-singular (a logdet of about -46 per dimension then
dominates the KL), and O(1) raw outputs wobble the factor while the
decoder is deciding whether to use the latent at all. The cure, shared by
every amortized family: bias the slab's diagonal slots by +1 (the factor
starts near the identity, the prior-matched init of the non-LOCAL packed
family) and scale the factor slots 0.1x (the encoder can still express any
factor through 10x output weights; only the init noise shrinks).
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.linalg import fill_triangular_diag_indices


def packed_slab_conditioning(d_z, feed_size):
    """(bias, scale) arrays for a fullrank_packed local of latent dim d_z.
    Families that need no conditioning do not call this
    (:func:`condition_slab` takes ``bias=None`` as the identity)."""
    diag_slots = d_z + np.asarray(fill_triangular_diag_indices(d_z))
    bias = np.zeros(feed_size, np.float32)
    bias[diag_slots] = 1.0
    scale = np.full(feed_size, 0.1, np.float32)
    scale[:d_z] = 1.0
    return bias, scale


def condition_slab(slab, bias, scale):
    """Apply (bias, scale) to a raw encoder slab; the identity when bias is
    None."""
    if bias is None:
        return slab
    scale = torch.as_tensor(scale, dtype=slab.dtype, device=slab.device)
    bias = torch.as_tensor(bias, dtype=slab.dtype, device=slab.device)
    return slab * scale + bias
