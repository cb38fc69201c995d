"""henbun_tpu_torch — the PyTorch/CUDA port of henbun_tpu.

The same user-facing API as the JAX package: Parameterized/Variable trees,
variational posteriors, densities/priors/transforms, GP kernels and
(sparse) GP sampling, ``@AutoOptimize`` objectives, collections, the
``henbunrc`` settings, and ``BatchedOptimizer`` fleets. Batched float32
Cholesky factorizations and triangular solves run through hand-written CUDA
kernels (``ops/cuda_chol.py``, ``ops/cuda_solve.py``), and the batched
Laplace Newton loop through a third (``ops/cuda_newton.py``). The natural
gradient (``optimizers.py``) factors and inverts its Gaussians through the
first two, and so do the sweeps of a fleet's expectation propagation
(``inference/ep.py``). Parameter checkpoints (``Parameterized.save``) are
the JAX package's ``.npz`` format, readable by either package. ``io``
streams row files larger than host memory into training through a C++
prefetching loader (built with ``g++`` at first use). ``serving`` exports
a fitted model's prediction as a self-contained ``torch.export`` program
(K1 and K2 are ``torch.library`` custom ops, ``ops/library.py``), and
``parallel`` shards training and the samplers' chains over a
``torch.distributed`` device mesh.

A Model lives on ``[cuda] device`` unless the caller names a device; with
no CUDA device, pass ``device="cpu"``.

>>> import henbun_tpu_torch as hb
>>> X, Y = hb.models.make_sine_dataset(n=40)
>>> m = hb.models.GPR(X=X, Y=Y, seed=0)
>>> opt = m.ELBO_gaussian().compile(learning_rate=0.01)
>>> opt.optimize(maxiter=2000)
"""
from ._version import __version__

from . import _settings
from ._settings import settings

from .core import rng as random
from .core.rng import set_seed

from .core import param as _core_param
from . import transforms
from . import densities
from . import priors
from . import variationals
from . import ops
from . import model
from . import nn
from . import gp
from . import optimizers
from . import utils
from . import batched
from . import scoping
from .batched import BatchedOptimizer
from . import inference
from . import io
from . import interop
from . import parallel
from . import serving

# `hb.param.*` API surface, as in the JAX package's layout
from . import param

Model = model.Model
AutoOptimize = model.AutoOptimize
Optimizer = model.Optimizer
adam = model.adam
Variable = _core_param.Variable
Parameterized = _core_param.Parameterized
ParamList = _core_param.ParamList
Data = _core_param.Data
MinibatchData = _core_param.MinibatchData
graph_key = _core_param.graph_key


def __getattr__(name):
    """``models`` is imported at first use, so a process that only loads
    and serves an exported artifact (``serving``) never imports the model
    families."""
    if name == "models":
        import importlib

        return importlib.import_module(".models", __name__)
    raise AttributeError("module %r has no attribute %r" % (__name__, name))
