"""Model base class and the training loop.

``Model`` (tree root, ``setUp``, ``initialize``, ``run``, ``draws``,
``validate``, ``test_feed_dict``), ``Indexer`` (shuffled 90/10 train/test
split with random-with-replacement minibatch draws), the ``AutoOptimize``
decorator and the ``Optimizer`` (``compile`` / ``run`` / ``optimize``).

A Model lives on one ``torch.device``: ``settings.cuda.device`` unless the
caller names one. Without a CUDA device, a Model built without
``device="cpu"`` raises; nothing carries on silently on the CPU.

The training loop runs eagerly, ``settings.cuda.scan_chunk`` steps per
chunk: each step draws its minibatch and noise on the device, evaluates the
objective, back-propagates and takes one ``torch.optim`` step, and the
per-step objectives stay on the device. The host syncs once per chunk, when
it copies the objective history back (plus one flag per factorization that
``safe_cholesky`` reads to decide on a jitter retry). Before each chunk the
parameters and optimizer state are snapshotted on the host, so a chunk whose
objective goes non-finite is rolled back and retried once with fresh noise.
"""
from __future__ import annotations

import time
from functools import wraps

import numpy as np
import torch

from ._settings import settings, resolve_device
from .core import context as _ctx
from .core import rng as _rng
from .core.param import Parameterized, MinibatchData, graph_key


def adam(learning_rate=0.001, b1=0.9, b2=0.999, eps=1e-8):
    """An optimizer factory ``params -> torch.optim.Adam`` with the defaults
    of ``optax.adam``: the update lr * m_hat / (sqrt(v_hat) + eps) keeps eps
    outside the root, as optax does with ``eps_root=0``."""

    def make(params):
        return torch.optim.Adam(
            params, lr=learning_rate, betas=(b1, b2), eps=eps
        )

    return make


class Model(Parameterized):
    """Tree root; subclasses define parameters in setUp and objectives as
    methods decorated with @AutoOptimize().

    seed: seeds the model's device ``torch.Generator`` (reparameterization
    noise, minibatch draws); default: drawn from the host init RNG.
    device: where parameters and data live; default ``[cuda] device``."""

    def __init__(self, name="model", seed=None, device=None, **kw):
        Parameterized.__init__(self)
        self._name = name
        self._device = resolve_device(device)
        self._index = Indexer()
        if seed is None:
            seed = int(_rng.get_rng().integers(0, 2**31 - 1))
        self._seed = int(seed)
        self._generator = torch.Generator(device=self._device)
        self._generator.manual_seed(self._seed)
        self.setUp(**kw)

    @property
    def name(self):
        return self._name

    @property
    def device(self):
        return self._device

    @property
    def generator(self):
        """The device generator all of this model's noise is drawn from."""
        return self._generator

    def setUp(self):
        """Parameter definitions belong here; overridden by subclasses."""
        pass

    def run(self, fn, feed_dict=None, minibatch_index=None, noise=None,
            training=True):
        """Evaluate `fn(model)` with the full data (or the given minibatch
        index) and the current committed parameters, without gradients.
        Each call draws fresh noise unless `noise` ({path: u}) injects it."""
        self.initialize()
        params = self.param_dict()
        data = self._gather_data(minibatch_index)
        if feed_dict:
            data.update(
                {k: torch.as_tensor(v, device=self._device) for k, v in feed_dict.items()}
            )
        with torch.no_grad(), _ctx.trace(
            self, params, data, self._generator, noise=noise, training=training
        ):
            return fn(self)

    def draws(self, fn, num, minibatch_index=None):
        """`num` posterior draws of `fn(model)`, stacked on a leading draw
        axis; each draw takes fresh noise."""
        return torch.stack(
            [self.run(fn, minibatch_index=minibatch_index) for _ in range(num)]
        )

    def _gather_data(self, minibatch_index=None):
        out = {}
        for v in self.get_variables(graph_key.DATA):
            path = v.path_to(self)
            arr = v.device_value(self._device)
            if isinstance(v, MinibatchData) and minibatch_index is not None:
                idx = torch.as_tensor(np.asarray(minibatch_index), device=self._device)
                arr = arr.index_select(0, idx)
            out[path] = arr
        return out

    def validate(self):
        """Check minibatch data sizes agree and (re)set up the Indexer.
        Unfed LOCAL variables are caught at evaluation time with the node's
        long_name in the error."""
        minibatch_data = [
            d
            for d in self.get_variables(graph_key.DATA)
            if isinstance(d, MinibatchData)
        ]
        for d in minibatch_data[1:]:
            if d.data_size != minibatch_data[0].data_size:
                raise ValueError(
                    "Minibatch data " + d.long_name + " is not the same size."
                )
        if len(minibatch_data) > 0:
            data_size = minibatch_data[0].data_size
            if self._index.data_size is None or self._index.data_size != data_size:
                self._index.setUp(data_size)

    def test_feed_dict(self, minibatch_size=None):
        """Indices of a random test minibatch."""
        return self._index.test_index(minibatch_size)


class Indexer:
    """Shuffled train/test split with random-with-replacement minibatch
    index draws (host numpy).

    ``test_frac`` (default 0.1) is read at every ``setUp``; set it before
    compile()/optimize() to resize the held-out split."""

    def __init__(self, test_frac=0.1):
        self.data_size = None
        self.test_frac = test_frac

    def setUp(self, data_size):
        self.data_size = data_size
        self.test_size = int(np.floor(self.data_size * self.test_frac))
        self.train_size = data_size - self.test_size
        index = np.arange(self.data_size)
        _rng.get_rng().shuffle(index)
        self._train_index = index[: self.train_size]
        self._test_index = index[self.train_size :]

    def train_index(self, minibatch_size):
        return self._train_index[
            _rng.get_rng().integers(0, self.train_size, minibatch_size)
        ]

    def test_index(self, minibatch_size):
        if minibatch_size is None:
            return None
        if self.test_size == 0:
            raise ValueError(
                "no held-out rows: the Indexer was set up with test_frac=0. "
                "Set model._index.test_frac before optimize/compile to keep "
                "a test split."
            )
        return self._test_index[
            _rng.get_rng().integers(0, self.test_size, minibatch_size)
        ]


def _resolve_method(model, method):
    """Accept an objective as a plain method, an @AutoOptimize-decorated
    method (unwrap), a method-name string, or an existing Optimizer."""
    if isinstance(method, str):
        method = getattr(type(model), method)
    if isinstance(method, Optimizer):
        method = method.likelihood_method
    return getattr(method, "__wrapped__", method)


class AutoOptimize:
    """Decorator turning a model method into a compilable objective; the
    Optimizer is created on first access and cached on the instance."""

    def __call__(self, method):
        @wraps(method)
        def runnable(instance):
            optimizer_name = "_" + method.__name__ + "_AF_optimizer"
            if hasattr(instance, optimizer_name):
                optimizer = getattr(instance, optimizer_name)
            else:
                optimizer = Optimizer(instance, method)
                setattr(instance, optimizer_name, optimizer)
            return optimizer

        return runnable


def _to_host(obj):
    """Host copy of a (nested) optimizer state: every tensor cloned to the
    CPU, everything else as is."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().clone()
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def _average_samples(core, num_samples):
    """With S > 1, average S independently drawn evaluations of the
    objective (diagnostics keep the maximum)."""
    if num_samples <= 1:
        return core

    def averaged(trainable, frozen, d, generator, noise):
        outs = [core(trainable, frozen, d, generator, noise) for _ in range(num_samples)]
        val = torch.mean(torch.stack([o[0] for o in outs]))
        diags = {
            k: torch.max(torch.stack([o[1][k] for o in outs]), dim=0).values
            for k in outs[0][1]
        }
        return val, diags

    return averaged


class Optimizer:
    """An objective with its parameters and optimizer state: evaluation and
    chunked optimization.

    ``noise_source``: None, or a callable ``step -> {path: u}`` whose
    result is injected as the noise of the step with that global index (a
    test hands in the noise the JAX package drew). ``row_source``: None,
    or a callable ``step -> rows`` giving that step's minibatch rows, as
    indices into the arrays the step draws from (the model's data; the
    pre-gathered train split in block mode; a ShardedOptimizer rank's
    shard) in place of the drawn ones."""

    def __init__(self, model_instance, likelihood_method):
        self.model = model_instance
        self.likelihood_method = likelihood_method
        self.optimizer = None         # factory: params -> torch.optim.Optimizer
        self.torch_optimizer = None
        self.collection = None
        self.global_step = 0
        self.history = []             # per-chunk objective traces (host arrays)
        self.noise_source = None
        self.row_source = None
        from .utils.profiling import StepMetrics

        self.metrics = StepMetrics()
        self._trainable = None
        self._frozen = None
        self._mb_paths = None
        self._evaluate_core_aux = None  # (trainable, frozen, d, gen, noise) -> (value, diags)
        self._diag_guards = {}          # {name: (tol, hint)}
        self._compiled = False

    @property
    def device(self):
        return self.model.device

    # ------------------------------------------------------------------ build
    def compile(self, optimizer=None, collection=graph_key.VARIABLES,
                global_step=None, learning_rate=0.001, num_elbo_samples=1):
        """Build the objective and the optimizer state.

        - optimizer: a factory ``params -> torch.optim.Optimizer``
          (default: :func:`adam` at ``learning_rate``). A learning-rate
          schedule belongs in the factory. A factory with a true
          ``henbun_natgrad`` attribute (``optimizers.natural_gradient``)
          gets the ``{path: tensor}`` dict instead of the list.
        - collection: the variable tag to optimize; everything else is frozen.
        - num_elbo_samples: S > 1 averages S independently drawn samples of
          the objective per step.
        """
        if global_step is not None:
            raise ValueError(
                "compile(global_step=...) is not supported: put a learning-"
                "rate schedule in the optimizer factory. The step counter "
                "itself is Optimizer.global_step."
            )
        if settings.verbosity.tf_compile_verb:
            print("compiling...")
        self.optimizer = optimizer if optimizer is not None else adam(learning_rate)
        self.collection = collection
        self._prepare_models()
        model = self.model
        self._mb_paths = frozenset(
            v.path_to(model)
            for v in model.get_variables(graph_key.DATA)
            if isinstance(v, MinibatchData)
        )
        trainable, frozen = self._param_dicts()
        if len(trainable) == 0:
            raise ValueError(
                "no variables found in collection %r" % (self.collection,)
            )
        self._trainable = {k: v.requires_grad_(True) for k, v in trainable.items()}
        self._frozen = frozen
        # the natural gradient's factory takes the {path: tensor} dict; a
        # plain one takes the list of tensors
        if getattr(self.optimizer, "henbun_natgrad", False):
            self.torch_optimizer = self.optimizer(self._trainable)
        else:
            self.torch_optimizer = self.optimizer(list(self._trainable.values()))
        self._diag_guards = {}
        self._evaluate_core_aux = _average_samples(
            self._objective(self._diag_guards), int(num_elbo_samples)
        )
        # eager validation: evaluate once (with a throwaway generator) so
        # unfed LOCAL variables and shape errors surface at compile()
        check = torch.Generator(device=self.device)
        check.manual_seed(0)
        with torch.no_grad():
            self._evaluate_core_aux(
                self._trainable, self._frozen, self._data_args(), check, None
            )
        self._compiled = True
        if settings.verbosity.tf_compile_verb:
            print("finished.")
        return self

    # Hooks that BatchedOptimizer overrides: model preparation, the
    # parameter/data dicts, the objective, write-back and row selection.
    def _prepare_models(self):
        self.model.initialize()
        self.model.validate()

    def _param_dicts(self):
        """(trainable, frozen) free-space dicts on the device."""
        m = self.model
        return m.param_dict(self.collection), m.param_dict(exclude=self.collection)

    def _data_args(self):
        return self.model._gather_data()

    def _objective(self, guards):
        model = self.model
        method = self.likelihood_method

        def core(trainable, frozen, d, generator, noise):
            params = dict(trainable)
            params.update(frozen)
            with _ctx.trace(model, params, d, generator, noise=noise) as ctx:
                val = method(model)
                diags = dict(ctx.diagnostics)
                guards.update(ctx.diagnostic_guards)
            return val, diags

        return core

    def _commit_params(self, trainable):
        """Write optimized free-space values back into the model tree."""
        self.model.set_param_dict(trainable)

    def _models(self):
        return [self.model]

    def _require_compiled(self):
        if not self._compiled:
            self.compile()

    # --------------------------------------------------------------- resume
    def save_state(self, path):
        """Checkpoint the full training state for an exact resume: the
        trainable tensors, the optimizer's ``state_dict()`` (the natural
        gradient's too: its ``rest`` state and adaptive scales), the global
        step and the model's generator state. A ``torch.save`` file, which
        only this package reads (optax and torch.optim states differ);
        parameters alone travel between the packages as
        ``Parameterized.save``'s npz."""
        self._require_compiled()
        self._refresh_params()  # staged assignments belong in the checkpoint
        torch.save(
            {
                "trainable": {k: v.detach().cpu().clone() for k, v in self._trainable.items()},
                "opt_state": _to_host(self.torch_optimizer.state_dict()),
                "global_step": int(self.global_step),
                "generator": self.model.generator.get_state(),
            },
            path,
        )

    def restore_state(self, path):
        """Inverse of :meth:`save_state`: resuming a run after this produces
        the exact step sequence the uninterrupted run would have (same
        parameters, optimizer state and generator stream)."""
        self._require_compiled()
        # consume any pending staged assignments now, onto the pre-restore
        # values they targeted; otherwise the next _refresh_params would
        # apply them over the restored parameters
        self._refresh_params()
        st = torch.load(path, map_location="cpu", weights_only=True)
        if set(st["trainable"]) != set(self._trainable):
            raise ValueError(
                "checkpoint holds %r, this optimizer trains %r"
                % (sorted(st["trainable"]), sorted(self._trainable))
            )
        with torch.no_grad():
            for k, v in st["trainable"].items():
                self._trainable[k].copy_(v)
        self.torch_optimizer.load_state_dict(st["opt_state"])
        self.global_step = int(st["global_step"])
        self.model.generator.set_state(st["generator"])
        self._commit_params(self._trainable)
        return self

    def _refresh_params(self):
        """Pick up any staged assignments made since the last call: their
        values are copied into the trained tensors in place, so the
        optimizer keeps its binding and its state."""
        models = self._models()
        if any(m.initialize_ops for m in models):
            for m in models:
                m.initialize()
            trainable, self._frozen = self._param_dicts()
            with torch.no_grad():
                for k, v in trainable.items():
                    self._trainable[k].copy_(v)
        for m in models:
            m.validate()

    def _snapshot(self):
        return (
            {k: v.detach().cpu().clone() for k, v in self._trainable.items()},
            _to_host(self.torch_optimizer.state_dict()),
        )

    def _rollback(self, snap):
        with torch.no_grad():
            for k, v in snap[0].items():
                self._trainable[k].copy_(v)
        self.torch_optimizer.load_state_dict(snap[1])

    # ------------------------------------------------------------ minibatch
    def _row_axis(self):
        """The axis of a MinibatchData array that indexes rows."""
        return 0

    def _fleet_rows(self):
        """(the number of models a fleet draws its rows for, the slice of
        them this process trains): all of its models here; a rank of a
        sharded fleet draws the whole fleet's rows and keeps its block."""
        n = len(self._models())
        return n, slice(0, n)

    def _take_rows(self, data, idx):
        """Data with the minibatch paths' rows `idx` taken (shared rows)."""
        ax = self._row_axis()
        return {
            path: arr.index_select(ax, idx) if path in self._mb_paths else arr
            for path, arr in data.items()
        }

    def _prepare_optimize_data(self, data, minibatch_size, mode):
        """Returns (data, train_idx, train_size). Block mode gathers the
        permuted train split once up front so every step reads a contiguous
        block."""
        if minibatch_size is None:
            return data, None, 1
        model = self.model
        if model._index.data_size is None:
            raise ValueError(
                "minibatch_size=%r was passed but model %r has no "
                "MinibatchData — declare minibatched arrays with "
                "hb.MinibatchData, or drop minibatch_size."
                % (minibatch_size, model.name)
            )
        train_idx = torch.as_tensor(model._index._train_index, device=self.device)
        if mode == "block":
            data = self._take_rows(data, train_idx)
        return data, train_idx, int(model._index.train_size)

    def _make_select_batch(self, minibatch_size, train_size, mode):
        """select(data, train_idx, generator) -> the step's data dict.
        'random' draws uniform rows with replacement through the permuted
        train index; 'block' takes a random contiguous block of the
        pre-gathered train split. Drawn on the device, independently per
        model of a fleet."""
        if minibatch_size is None:
            return lambda data, train_idx, g: data
        if mode not in ("random", "block"):
            raise ValueError("minibatch_mode must be 'random' or 'block'")
        mb = int(minibatch_size)
        mb_paths = self._mb_paths
        # a fleet draws its rows per model: a leading [M] on the draws, of
        # which it keeps `block`
        lead, block = (), None
        if self._row_axis():
            n, block = self._fleet_rows()
            lead = (n,)

        def select(data, train_idx, g):
            if mode == "block":
                hi = max(train_size - mb + 1, 1)
                start = torch.randint(0, hi, lead + (1,), generator=g, device=g.device)
                rows = start + torch.arange(mb, device=g.device)
            else:
                sel = torch.randint(0, train_size, lead + (mb,), generator=g,
                                    device=g.device)
                rows = train_idx[sel]
            out = {}
            if lead:
                rows = rows[block]
            for path, arr in data.items():
                if path not in mb_paths:
                    out[path] = arr
                elif lead:  # per-model rows of a stacked [M, N, ...] array
                    out[path] = arr[torch.arange(rows.shape[0], device=g.device)[:, None], rows]
                else:
                    out[path] = arr.index_select(0, rows)
            return out

        return select

    # ------------------------------------------------------------------- eval
    def feed_dict(self, minibatch_size=None, training=True):
        """Minibatch indices for evaluation: None → full data, training →
        train split, else → test split."""
        if minibatch_size is None:
            return None
        if self.model._index.data_size is None:
            raise ValueError(
                "minibatch_size=%r was passed but model %r has no "
                "MinibatchData — declare minibatched arrays with "
                "hb.MinibatchData, or drop minibatch_size."
                % (minibatch_size, self.model.name)
            )
        if training:
            return self.model._index.train_index(minibatch_size)
        return self.model._index.test_index(minibatch_size)

    def run(self, minibatch_size=None, training=True, noise=None):
        """Evaluate the objective at the current parameters (fresh noise
        unless `noise` injects it); returns a host numpy value."""
        self._require_compiled()
        self._refresh_params()
        data = self._data_args()
        idx = self.feed_dict(minibatch_size, training)
        if idx is not None:
            data = self._take_rows(
                data, torch.as_tensor(np.asarray(idx), device=self.device)
            )
        with torch.no_grad():
            val, _ = self._evaluate_core_aux(
                self._trainable, self._frozen, data, self.model.generator, noise
            )
        return val.cpu().numpy()

    # --------------------------------------------------------------- optimize
    def _step(self, d, noise):
        """One optimization step; returns the objective (on the device) and
        the reported diagnostics."""
        opt = self.torch_optimizer
        opt.zero_grad(set_to_none=True)
        val, diags = self._evaluate_core_aux(
            self._trainable, self._frozen, d, self.model.generator, noise
        )
        (-val).backward()
        val, diags = self._reduce_step(val.detach(), {k: v.detach() for k, v in diags.items()})
        opt.step()
        return val, diags

    def _reduce_step(self, val, diags):
        """After backward(), before the update: the identity here; the
        sharded drivers all-reduce the gradients and the objective."""
        return val, diags

    def _run_chunk(self, n, data, train_idx, select):
        """n steps; the objectives stay on the device until the caller
        copies them."""
        g = self.model.generator
        objs = torch.empty(n, dtype=settings.dtypes.float_type, device=self.device)
        diag_rows = {}
        for s in range(n):
            noise = (
                self.noise_source(self.global_step + s)
                if self.noise_source is not None
                else None
            )
            if self.row_source is not None:
                rows = torch.as_tensor(np.asarray(self.row_source(self.global_step + s)),
                                       device=self.device)
                d = self._take_rows(data, rows)
            else:
                d = select(data, train_idx, g)
            val, diags = self._step(d, noise)
            objs[s] = val
            for k, v in diags.items():
                diag_rows.setdefault(k, []).append(v)
        return objs, {k: torch.stack(v) for k, v in diag_rows.items()}

    def optimize(self, maxiter=1, minibatch_size=None, callback=None,
                 nan_guard=True, minibatch_mode="random"):
        """Run `maxiter` optimization steps in chunks of
        ``settings.cuda.scan_chunk``.

        minibatch_mode: 'random' (uniform rows with replacement) or 'block'
        (a random contiguous block of the pre-shuffled train split).

        KeyboardInterrupt-safe: parameters advanced so far are committed
        back into the model tree.

        nan_guard: if a chunk produces a non-finite objective, roll the
        parameters and optimizer state back to the chunk start (host
        snapshots) and retry once with fresh noise; a second failure
        raises.
        """
        self._require_compiled()
        self._refresh_params()
        data, train_idx, train_size = self._prepare_optimize_data(
            self._data_args(), minibatch_size, minibatch_mode
        )
        select = self._make_select_batch(minibatch_size, train_size, minibatch_mode)

        from .utils.profiling import trace_if_enabled

        chunk_size = int(settings.cuda.scan_chunk)
        done = 0
        try:
            with trace_if_enabled("optimize"):
                while done < maxiter:
                    n = min(chunk_size, maxiter - done)
                    snap = self._snapshot() if nan_guard else None
                    t0 = time.perf_counter()
                    objs, diags = self._run_chunk(n, data, train_idx, select)
                    objs_host = objs.cpu().numpy()  # host sync, once per chunk
                    if nan_guard and not np.isfinite(objs_host).all():
                        bad_at = int(np.argmax(~np.isfinite(objs_host)))
                        self._rollback(snap)
                        # the generator has moved on: fresh noise
                        objs, diags = self._run_chunk(n, data, train_idx, select)
                        objs_host = objs.cpu().numpy()
                        if not np.isfinite(objs_host).all():
                            # leave the model at the last GOOD state
                            self._rollback(snap)
                            raise FloatingPointError(
                                "objective went non-finite at step ~%d twice "
                                "in a row; aborting (first failure at chunk "
                                "offset %d).%s"
                                % (self.global_step + n, bad_at, self._nan_hint())
                            )
                        if settings.verbosity.optimisation_verb:
                            print(
                                "[henbun] non-finite objective at chunk offset"
                                " %d — rolled back and retried with fresh noise"
                                % bad_at
                            )
                    dt = time.perf_counter() - t0
                    extra = self._check_diagnostics(diags, n, snap) if diags else None
                    done += n
                    self.global_step += n
                    self.history.append(objs_host)
                    self.metrics.record(self.global_step, objs_host, dt, n, extra=extra)
                    if callback is not None:
                        callback(self.global_step, objs_host)
        except KeyboardInterrupt:
            pass
        finally:
            self._commit_params(self._trainable)
        return self

    def _nan_hint(self):
        """The remedy a nan-guard abort names: the model's own hint if it
        declares one, else the objective-pairing rule under the natural
        gradient, else nothing."""
        model_hint = getattr(self.model, "_nan_hint", None)
        if model_hint:
            return " " + model_hint
        if getattr(self.optimizer, "henbun_natgrad", False):
            return (
                " Likely cause with natural gradients: a stochastic (MC)"
                " objective with gamma beyond the gradient estimate's"
                " accuracy. The pairing rule is MC ELBO -> Adam (or"
                " natural_gradient(..., gamma<=0.01, adaptive=True));"
                " analytic/deterministic ELBO -> unit-gamma natgrad."
            )
        return ""

    def _check_diagnostics(self, diags, n, snap):
        """Log each reported diagnostic's latest value; a guarded one aborts
        on a PERSISTENT violation (the chunk ends above tolerance, or more
        than 25% of its steps violate), rolled back to the chunk start when
        a snapshot exists. An isolated spike only warns."""
        extra = {}
        for dname, darr in sorted(diags.items()):
            dhost = darr.cpu().numpy().reshape(-1)
            extra[dname] = float(dhost[-1])
            guard = self._diag_guards.get(dname)
            if guard is None:
                continue
            tol, hint = guard
            worst = float(np.max(dhost))
            if worst <= tol:
                continue
            viol_frac = float(np.mean(dhost > tol))
            if dhost[-1] > tol or viol_frac > 0.25:
                if snap is not None:
                    self._rollback(snap)
                raise FloatingPointError(
                    "diagnostic %r exceeded tolerance %.3g persistently "
                    "during steps %d-%d (worst %.3g, %d%% of steps, final "
                    "%.3g); aborting%s.%s"
                    % (dname, tol, self.global_step, self.global_step + n,
                       worst, int(round(100 * viol_frac)), float(dhost[-1]),
                       " (chunk rolled back)" if snap is not None else "", hint)
                )
            if settings.verbosity.optimisation_verb:
                print(
                    "[henbun] diagnostic %r spiked to %.3g (> %.3g) "
                    "transiently in steps %d-%d (%d%% of steps); continuing"
                    % (dname, worst, tol, self.global_step,
                       self.global_step + n, int(round(100 * viol_frac)))
                )
        return extra
