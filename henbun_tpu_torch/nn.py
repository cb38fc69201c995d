"""Dense feed-forward encoders for amortized inference.

``MatBias`` (a w, b pair computing ``clip(x @ w + b)``) and ``NeuralNet``
(a chain of MatBias layers with per-layer activations; ``variable_types``
may be a ``Variational`` class for Bayesian NN weights). Layered through
leading ``n_layers`` axes, which ``torch.matmul`` batches. The products are
plain ``torch.matmul``: the JAX package computes them outside any Pallas
kernel too.
"""
from __future__ import annotations

import torch

from .core.param import Variable, Parameterized, graph_key
from .ops.linalg import clip


class MatBias(Parameterized):
    """A matrix/bias pair computing clip(x @ w + b)."""

    def __init__(
        self,
        nodes,
        n_layers=[],
        mean=0.0,
        stddev=1.0,
        variable=Variable,
        collections=None,
    ):
        if len(nodes) != 2:
            raise ValueError("MatBias takes nodes=[n_in, n_out], got %r" % (nodes,))
        Parameterized.__init__(self)
        collections = collections if collections is not None else [graph_key.VARIABLES]
        self.w = variable(
            shape=[nodes[0], nodes[1]],
            n_layers=n_layers,
            mean=mean,
            stddev=stddev,
            collections=collections,
        )
        self.b = variable(
            shape=[1, nodes[1]],
            n_layers=n_layers,
            mean=mean,
            stddev=stddev,
            collections=collections,
        )

    def __call__(self, x):
        return clip(torch.matmul(x, self.w) + self.b)


def sigmoid(x, name=None):
    return torch.sigmoid(x)


def relu(x, name=None):
    return torch.relu(x)


def tanh(x, name=None):
    return torch.tanh(x)


class NeuralNet(Parameterized):
    """A dense feed-forward net: len(nodes)-1 MatBias layers with
    activations between them (none after the last).

    - variable_types: Variable (point weights) or a Variational subclass
      (Bayesian NN weights, sampled afresh in each evaluation); one type or
      a list of one per layer.
    - neuron_types: one activation or a list, default sigmoid.
    """

    def __init__(
        self,
        nodes,
        n_layers=[],
        mean=0.0,
        stddev=1.0,
        variable_types=Variable,
        neuron_types=sigmoid,
        collections=None,
    ):
        Parameterized.__init__(self)
        collections = collections if collections is not None else [graph_key.VARIABLES]
        self.nodes = nodes
        if not isinstance(variable_types, list):
            variable_types = [variable_types for _ in range(len(nodes) - 1)]
        if not isinstance(neuron_types, list):
            self.neuron_types = [neuron_types for _ in range(len(nodes) - 2)]
        else:
            self.neuron_types = neuron_types
        self._matbias_list = []
        for i in range(len(nodes) - 1):
            matbias = MatBias(
                nodes=[nodes[i], nodes[i + 1]],
                n_layers=n_layers,
                mean=mean,
                stddev=stddev,
                variable=variable_types[i],
                collections=collections,
            )
            self._matbias_list.append(matbias)
            setattr(self, "matbias" + str(i), matbias)

    def __call__(self, x):
        y = x
        for i in range(len(self.nodes) - 2):
            y = self.neuron_types[i](self._matbias_list[i](y))
        return self._matbias_list[-1](y)

    def __getitem__(self, i):
        return self._matbias_list[i]
