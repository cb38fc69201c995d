"""Every input of a run, made from ``--seed``: data, initial weights,
reparameterization noise and request streams. Drawn on the device with a
``torch.Generator`` of its own per purpose, in a few large calls, so the
same seed gives the same inputs and no purpose shifts another's draws.

What varies with the seed is values, never the amount of work: every seed
gets the same sizes (data size, fleet, the set of request sizes), in
another order where order matters.
"""
from __future__ import annotations

import math
import zlib

import numpy as np
import torch

POSITIVE_FLOOR = 1e-6  # the port's positive transform: softplus(x) + 1e-6


def subseed(seed, tag):
    """A 63-bit seed for one purpose (`tag`) of a run seeded with `seed`,
    any whole number."""
    entropy = [int(seed) % 2 ** 64, zlib.crc32(tag.encode())]
    return int(np.random.SeedSequence(entropy).generate_state(1, np.uint64)[0] % 2 ** 63)


def generator(seed, tag, device):
    g = torch.Generator(device=device)
    g.manual_seed(subseed(seed, tag))
    return g


def inputs(spec, models, n, g, device):
    """[models, n, 1] float32 inputs: ``grid`` (n evenly spaced points on
    [low, high], as the notebook's ``make_sine_dataset``) or
    ``sorted_uniform`` (n sorted U[low, high] draws a model)."""
    lo, hi = float(spec["low"]), float(spec["high"])
    if spec["inputs"] == "grid":
        x = torch.linspace(lo, hi, n, device=device, dtype=torch.float32)
        return x.expand(models, n).clone()[..., None]
    if spec["inputs"] == "sorted_uniform":
        x = lo + (hi - lo) * torch.rand(models, n, generator=g, device=device)
        return torch.sort(x, dim=1).values[..., None]
    raise ValueError("unknown inputs %r" % spec["inputs"])


def regression_data(spec, models, n, g, device):
    """(X, Y), each [models, n, 1] float32: y = sin(x) + noise N(0, 1)."""
    X = inputs(spec, models, n, g, device)
    Y = torch.sin(X) + float(spec["noise"]) * torch.randn(X.shape, generator=g, device=device)
    return X, Y


def inverse_positive(y):
    """The free value whose softplus(x) + 1e-6 is y."""
    z = y - POSITIVE_FLOOR
    return z + torch.log(-torch.expm1(-z))


def free_values(spec, shapes, models, g, device):
    """{path: float32 free values [models, *shape]}, one draw per path in
    sorted order: ``["normal", mean, sd]`` draws the free value itself,
    ``["positive_uniform", lo, hi]`` draws a positive parameter's value
    uniformly and stores its free value."""
    out = {}
    for path in sorted(spec):
        kind, a, b = spec[path]
        shape = (models,) + tuple(shapes[path])
        if kind == "normal":
            out[path] = a + b * torch.randn(shape, generator=g, device=device)
        elif kind == "positive_uniform":
            y = a + (b - a) * torch.rand(shape, generator=g, device=device, dtype=torch.float64)
            out[path] = inverse_positive(y).float()
        else:
            raise ValueError("unknown initial value %r for %s" % (kind, path))
    return out


def request_sizes(spec, count, g):
    """`count` request sizes: a fixed set of ``set_size`` log-uniform
    sizes between ``min_points`` and ``max_points`` (its quantiles, so
    every seed serves the same sizes), each pass over the set in an order
    drawn from `g`."""
    k = int(spec["set_size"])
    lo, hi = math.log(spec["min_points"]), math.log(spec["max_points"])
    q = (np.arange(k) + 0.5) / k
    sizes = np.clip(np.rint(np.exp(lo + q * (hi - lo))), spec["min_points"],
                    spec["max_points"]).astype(np.int64)
    out = []
    while len(out) < count:
        perm = torch.randperm(k, generator=g, device=g.device).cpu().numpy()
        out.extend(sizes[perm].tolist())
    return out[:count]
