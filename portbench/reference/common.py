"""Pieces the references share: the positive transform, the unit RBF
gram, and Adam as the port's configurations run it."""
from __future__ import annotations

import torch

POSITIVE_FLOOR = 1e-6


def positive(x):
    """softplus(x) + 1e-6, the port's positive transform."""
    return torch.logaddexp(x, torch.zeros_like(x)) + POSITIVE_FLOOR


def tf32(x):
    """float32 rounded to TF32's 10 mantissa bits (to nearest, ties away
    from zero), as a tensor core reads its float32 operands."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


class Tf32Matmul(torch.autograd.Function):
    """a @ b with TF32 operands and float32 accumulation, forward and
    backward: the reference computed one precision below the float32 with
    TF32 off that the configurations state (the control of ``correct``)."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return tf32(a) @ tf32(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        return tf32(g) @ tf32(b).mT, tf32(a).mT @ tf32(g)


def tf32_matmul(a, b):
    """:class:`Tf32Matmul` of float32 operands (TF32 off for the product
    itself, so that only the rounding above makes it TF32)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return Tf32Matmul.apply(a, b)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def rbf(X, X2, lengthscale):
    """exp(-|x - x2|^2 / (2 l^2)) from the differences: [..., n, d],
    [..., m, d], l broadcast against [..., 1, d] -> [..., n, m]."""
    a, b = X / lengthscale, X2 / lengthscale
    d2 = torch.sum(torch.square(a[..., :, None, :] - b[..., None, :, :]), -1)
    return torch.exp(-0.5 * d2)


def adam_update(g, m, v, t, lr, b1=0.9, b2=0.999, eps=1e-8):
    """One Adam step of a leaf whose moments are `m` and `v` after `t`
    steps, on the gradient `g` of the negative objective, eps outside the
    root as optax's adam: (the new m, the new v, the leaf's change)."""
    m = b1 * m + (1 - b1) * g
    v = b2 * v + (1 - b2) * torch.square(g)
    t += 1
    return m, v, -lr * (m / (1 - b1 ** t)) / (torch.sqrt(v / (1 - b2 ** t)) + eps)


def adam_steps(objective, params, steps, lr, b1=0.9, b2=0.999, eps=1e-8):
    """`steps` Adam steps (:func:`adam_update`) that minimize
    -objective(params) (the port maximizes its objective by minimizing its
    negative) from fresh moments. Returns (the objective before each step,
    the first step's gradient, the parameters after the last step), each
    leaf detached."""
    p = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    values, first_grad = [], None
    for t in range(steps):
        val = objective(p)
        keys = sorted(p)
        grads = torch.autograd.grad(-val, [p[k] for k in keys])
        values.append(float(val.detach()))
        with torch.no_grad():
            g = dict(zip(keys, grads))
            if first_grad is None:
                first_grad = {k: gk.detach().clone() for k, gk in g.items()}
            for k in keys:
                m[k], v2[k], change = adam_update(g[k], m[k], v2[k], t, lr, b1, b2, eps)
                p[k].add_(change)
        del val, grads
    return values, first_grad, {k: v.detach() for k, v in p.items()}
