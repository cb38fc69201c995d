"""A counter-based standard-normal stream written in integer tensor ops.

An exported program (``serving``) cannot hold a ``torch.Generator``
seeded from an input, and an ``aten.randn`` inside it ignores any seed the
caller passes. So a served model's noise comes from here instead: each
value is a pure function of (seed, draw, path, position), computed with
int64 tensor ops that ``torch.export`` traces like any other, at a
symbolic shape too.

The bits are splitmix64's (Steele, Lea & Flood 2014): a key is mixed from
the seed, the draw index and the node's path (``zlib.crc32``), and output
i is ``mix(key + (i + 1) * gamma)``. Two outputs give two 24-bit uniforms
in (0, 1), and Box-Muller one standard normal. The int64 products wrap
mod 2^64, as the algorithm's unsigned arithmetic does; a logical shift is
an arithmetic shift masked to the low bits. The stream is not JAX's
threefry and not ``torch.randn``'s Philox: a fixed seed gives the same
draws bit for bit on one platform, another seed other draws.
"""
from __future__ import annotations

import math
import zlib

import torch


def _signed(x):
    return x - (1 << 64) if x >= 1 << 63 else x


_GAMMA = _signed(0x9E3779B97F4A7C15)
_M1 = _signed(0xBF58476D1CE4E5B9)
_M2 = _signed(0x94D049BB133111EB)
_U24 = 2.0 ** -24


def _srl(x, k):
    """Logical right shift of an int64 tensor."""
    return (x >> k) & ((1 << (64 - k)) - 1)


def mix(z):
    """splitmix64's finalizer on an int64 tensor."""
    z = (z ^ _srl(z, 30)) * _M1
    z = (z ^ _srl(z, 27)) * _M2
    return z ^ _srl(z, 31)


def key(seed, draw=0):
    """The int64 key of one draw of a seed (tensors or ints)."""
    seed = torch.as_tensor(seed, dtype=torch.int64)
    return mix(mix(seed + _GAMMA) + draw)


def normal(k, path, shape, dtype=torch.float32):
    """Standard normals of `shape` for the node at `path` under key `k`."""
    n = math.prod(shape)
    k = mix(k ^ (zlib.crc32(path.encode()) & 0x7FFFFFFF))
    i = torch.arange(1, 2 * n + 1, dtype=torch.int64, device=k.device)
    u = (_srl(mix(k + i * _GAMMA), 40).to(torch.float32) + 0.5) * _U24
    u1, u2 = u[:n], u[n:]
    z = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos((2.0 * math.pi) * u2)
    return z.reshape(shape).to(dtype)


class CounterNoise:
    """A stand-in for the trace context's ``noise={path: u}`` that holds
    every path: each node draws :func:`normal` under one key."""

    def __init__(self, k):
        self.key = k

    def __contains__(self, path):
        return True

    def draw(self, path, shape, dtype):
        return normal(self.key, path, shape, dtype)
