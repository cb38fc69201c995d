"""The fit driver: a configuration's objective trained the way a user
trains it, with the port's own loop and Adam. One model goes through
``Optimizer.optimize``; a fleet of ``models`` through
``BatchedOptimizer.optimize`` (stacked trees, ``torch.func.vmap``, one
backward).

Set-up builds the data, the models, the initial weights and the
optimizer, then makes one ``optimize`` call of ``warmup_steps`` (at least
three) at the default ``scan_chunk``: it warms every shape, and its first
three steps are what the reference follows from the seed. The window is
one ``optimize`` call of a fixed number of steps, ``--seconds`` times the
traffic's ``window_steps_per_s`` (about the rate on the H100 this was set
on): the rate is every model-step over all of the window's time, the
call's own overhead included. The window's last step is compared too:
step hooks on the program's ``torch.optim`` optimizer copy its parameters,
gradient and Adam state before the update, and the call hands back the
parameters after it.

Traffic keys: ``metric`` (the end-to-end metric's name, by default
``fit_steps_per_s``), ``models`` (the fleet; 1 for one model), optionally ``n``
(the data size, else the configuration's), ``window_steps_per_s``,
``warmup_steps``, ``trace_window_s`` and ``host_window_s`` (the traced
chunks, in seconds at the nominal rate).
"""
from __future__ import annotations

import gc
import sys
import time

import numpy as np
import torch

from .. import checks, data, roofline, tracing

UNIT = "model-steps/s"
CHECK_STEPS = 3


def synchronize(device):
    if device.type == "cuda":
        torch.cuda.synchronize()


class StepProbe:
    """Step hooks on an ``Optimizer``'s ``torch.optim`` optimizer that copy,
    at the steps asked for, what the comparison reads before the update:
    ``grad``, ``before`` (the parameters the step's objective was taken
    at) and ``state`` (Adam's moments and count). ``step`` counts the
    object's optimizer steps, its global step; a chunk that the nan guard
    runs again is counted twice, and :meth:`Driver._keep_last` then finds
    the count off and compares nothing."""

    def __init__(self, opt):
        self.opt, self.step, self.want, self.got = opt, int(opt.global_step), {}, {}
        opt.torch_optimizer.register_step_pre_hook(self._pre)
        opt.torch_optimizer.register_step_post_hook(self._post)

    def ask(self, step, *what):
        self.want.setdefault(step, set()).update(what)

    def take(self, what, step):
        return self.got.pop((what, step), None)

    def _params(self):
        return {k: p.detach().clone() for k, p in self.opt._trainable.items()}

    def _pre(self, optimizer, args, kwargs):
        want = self.want.get(self.step, ())
        if "grad" in want:
            self.got[("grad", self.step)] = {k: p.grad.detach().clone()
                                             for k, p in self.opt._trainable.items()}
        if "before" in want:
            self.got[("before", self.step)] = self._params()
        if "state" in want:
            st = optimizer.state
            self.got[("state", self.step)] = {
                k: (st[p]["exp_avg"].detach().clone(), st[p]["exp_avg_sq"].detach().clone(),
                    int(st[p]["step"]))
                for k, p in self.opt._trainable.items()}

    def _post(self, optimizer, args, kwargs):
        self.want.pop(self.step, None)
        self.step += 1


class Driver:
    def __init__(self, cell, seed, device):
        self.cell, self.seed, self.device = cell, int(seed), torch.device(device)
        cfg, tr = cell.config, cell.traffic
        self.B = int(tr["models"])
        self.n = int(tr.get("n", cfg.get("n", 0)))
        self.batched = self.B > 1
        self.noise_log = {}
        self.last_at, self.last_noise, self.last = -1, None, None
        self.metric = tr.get("metric", "fit_steps_per_s")
        self.e2e = {self.metric: UNIT}  # the end-to-end metric: its unit

    # ---------------------------------------------------------------- set-up
    def setup(self):
        import henbun_tpu_torch as hb
        from henbun_tpu_torch import models
        from henbun_tpu_torch.batched import BatchedOptimizer

        cfg, dev, B, n = self.cell.config, self.device, self.B, self.n
        hb.set_seed(data.subseed(self.seed, "host"))
        self.X, self.Y = data.regression_data(cfg["data"], B, n,
                                              data.generator(self.seed, "data", dev), dev)
        Xh, Yh = self.X.cpu().numpy(), self.Y.cpu().numpy()
        cls = getattr(models, cfg["model"])
        kwargs = cfg.get("model_kwargs", {})
        ms = [cls(seed=i, X=Xh[i], Y=Yh[i], device=dev, **kwargs) for i in range(B)]
        shapes = {k: tuple(v.shape) for k, v in ms[0].param_dict().items()}
        self.init = data.free_values(cfg["init"], shapes, B,
                                     data.generator(self.seed, "init", dev), dev)
        init_h = {k: v.cpu().numpy() for k, v in self.init.items()}
        for i, m in enumerate(ms):
            m.set_param_dict({k: v[i] for k, v in init_h.items()})
        if self.batched:
            opt = BatchedOptimizer(ms, cfg["objective"])
        else:
            opt = getattr(ms[0], cfg["objective"])()
        opt.compile(hb.adam(cfg["learning_rate"]))
        if cfg.get("noise"):
            opt.noise_source = self._noise_source(cfg["noise"])
        self.opt = opt
        self.probe = StepProbe(opt)
        self._first_call()

    def _noise_source(self, spec):
        """step -> {path: N(0, 1) [B, *shape]} (no fleet axis for one
        model), drawn on the device from the run's seed; the draws of the
        first steps and of the armed last step are kept for the
        reference."""
        g = data.generator(self.seed, "noise", self.device)
        sizes = {"n": self.n}
        lead = (self.B,) if self.batched else ()

        def draw(step):
            out = {path: torch.randn(lead + tuple(sizes.get(s, s) for s in shape),
                                     generator=g, device=self.device)
                   for path, shape in sorted(spec.items())}
            if step < CHECK_STEPS:
                self.noise_log[step] = out
            if step == self.last_at:
                self.last_noise = out
            return out

        return draw

    def _timed_optimize(self, steps, **kwargs):
        synchronize(self.device)
        t0 = time.perf_counter()
        self.opt.optimize(maxiter=steps, **kwargs)
        synchronize(self.device)
        return time.perf_counter() - t0

    def _objectives(self, since):
        """The objectives recorded since history entry `since`, one a step."""
        return np.concatenate([np.asarray(h).reshape(-1) for h in self.opt.history[since:]])

    def _first_call(self):
        """The object's first ``optimize`` call, of ``warmup_steps`` (at
        least three) at the default ``scan_chunk``: it warms every shape the
        window uses, and keeps what the reference follows of its first
        three steps: each step's objective, the first gradient as the
        optimizer got it, and the parameters after the third, as the fourth
        starts from them."""
        steps = max(CHECK_STEPS + 1, int(self.cell.traffic.get("warmup_steps", 0)))
        start = self.probe.step
        self.probe.ask(start, "grad")
        self.probe.ask(start + CHECK_STEPS, "before")
        since = len(self.opt.history)
        t = self._timed_optimize(steps)
        self.prog = {"losses": [float(x) for x in self._objectives(since)[:CHECK_STEPS]],
                     "grad": self.probe.take("grad", start),
                     "p3": self.probe.take("before", start + CHECK_STEPS)}
        print("fit set-up: the first call, %d steps, %.4f s" % (steps, t), file=sys.stderr)

    def _arm_last(self, steps):
        """Ask the probe for the last of the next call's `steps` steps;
        returns the history's length before the call."""
        self.last_at = self.probe.step + steps - 1
        self.last_noise = None
        self.probe.ask(self.last_at, "grad", "before", "state")
        return len(self.opt.history)

    def _keep_last(self, since):
        """What the probe took at the armed step, with the objective the
        program recorded there, the step's noise and the parameters the
        call handed back; None where the step count is off (a chunk run
        again)."""
        p, L = self.probe, self.last_at
        got = {w: p.take(w, L) for w in ("grad", "before", "state")}
        if p.step != self.opt.global_step or any(v is None for v in got.values()):
            print("fit: the probe counted %d steps, the optimizer %d; the last step is "
                  "not compared" % (p.step, self.opt.global_step), file=sys.stderr)
            self.last = None
            return
        got.update(loss=float(self._objectives(since)[-1]), noise=self.last_noise, step=L,
                   after=p._params())
        self.last = got

    def _steps_for(self, seconds):
        """A fixed amount of work: the traffic's ``window_steps_per_s``
        times `seconds`, never a number measured in the run."""
        return max(1, int(round(seconds * float(self.cell.traffic["window_steps_per_s"]))))

    # ----------------------------------------------------------------- window
    def window(self, seconds):
        """One ``optimize`` call of the steps that fill `seconds` at the
        traffic's nominal rate: ({the rate}, attempted steps, failed
        steps). Its last step is kept for the comparison."""
        steps = self._steps_for(seconds)
        since = self._arm_last(steps)
        elapsed = self._timed_optimize(steps)
        failed = int(np.sum(~np.isfinite(self._objectives(since))))
        self._keep_last(since)
        return {self.metric: self.B * steps / elapsed}, steps, failed

    def _over_chunk(self, steps, probe, check=False):
        """`probe` over the second of two chunks of `steps` steps of one
        ``optimize`` call, started and stopped by its callback: the steps
        and what a chunk does (the snapshot, the objectives' copy), not
        what the call does once (stacking, writing the parameters back).
        With `check`, the call's last step is kept for the comparison."""
        import henbun_tpu_torch as hb

        cfg = hb.settings.get_settings()
        cfg.cuda.scan_chunk = steps
        seen = []

        def callback(step, objs):
            seen.append(step)
            if len(seen) == 1:
                probe.start()
            elif len(seen) == 2:
                probe.stop()

        since = self._arm_last(2 * steps) if check else None
        with hb.settings.temp_settings(cfg):
            self.opt.optimize(maxiter=2 * steps, callback=callback)
        if check:
            self._keep_last(since)
        return probe.result()

    def traced(self):
        """The digest of the traced windows (see ``tracing``), each over one
        chunk of steps; the last call's last step is compared."""
        tr = self.cell.traffic
        k = self._steps_for(float(tr.get("trace_window_s", 2.0)))
        digest = self._over_chunk(k, tracing.DeviceTrace())
        # the first count after a traced chunk reads one sync more: count
        # once to throw away, then a chunk of 3 and one of 9
        syncs = {n: self._over_chunk(n, tracing.SyncCount()) for n in (1, 3, 9)}
        print("fit syncs: a chunk of %s" % syncs, file=sys.stderr)
        # last: while its profiler lives it keeps tensors of every traced
        # step alive
        kh = self._steps_for(float(tr.get("host_window_s", 0.5)))
        digest["host"] = self._over_chunk(kh, tracing.HostTrace(), check=True)
        digest["host"]["work"] = kh
        digest.update(driver="fit", work=k, syncs_per_step=(syncs[9] - syncs[3]) / 6.0,
                      step_flops=roofline.step_flops(self.cell.config["step_flops"],
                                                     models=self.B, n=self.n))
        return digest, k

    # ------------------------------------------------------------ correctness
    def release(self):
        """Free the program's state; keep what the comparison reads."""
        self.opt = self.probe.opt = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _one(self, v):
        """A leaf's fleet axis kept, or one model's dropped."""
        return v if self.batched else v[0]

    def _data(self, dtype):
        return {"X": self._one(self.X).to(dtype), "Y": self._one(self.Y).to(dtype)}

    def _reference_steps(self, dtype, matmul=torch.matmul):
        """The reference's three Adam steps from the run's own inputs, in
        `dtype`: {"losses", "grad", "p0", "p3"}."""
        from ..reference.common import adam_steps

        ref_mod = self.cell.reference
        p0 = {k: self._one(v).to(dtype) for k, v in self.init.items()}
        d = self._data(dtype)
        noise = [{k: v.to(dtype) for k, v in self.noise_log[s].items()}
                 for s in range(CHECK_STEPS)] if self.noise_log else None
        step = iter(range(CHECK_STEPS))

        def objective(p):
            s = next(step)
            return torch.sum(ref_mod.objective(p, d, noise[s] if noise else None,
                                               matmul=matmul))

        losses, grad, p3 = adam_steps(objective, p0, CHECK_STEPS,
                                      self.cell.config["learning_rate"])
        return {"losses": losses, "grad": grad, "p0": p0, "p3": p3}

    def _reference_last(self, dtype, matmul=torch.matmul):
        """The reference at the program's last compared step, in `dtype`:
        the objective and its gradient at the parameters the step started
        from, with the step's noise, and the change one Adam step makes
        from the program's Adam state there: {"loss", "grad", "step"}. It
        follows the program from the program's own state; the start is
        compared by :meth:`_reference_steps` from the seed."""
        from ..reference.common import adam_update

        last = self.last
        shape = {k: self._one(v).shape for k, v in self.init.items()}
        p = {k: v.to(dtype).reshape(shape[k]).requires_grad_(True)
             for k, v in last["before"].items()}
        noise = ({k: v.to(dtype) for k, v in last["noise"].items()}
                 if last["noise"] is not None else None)
        val = torch.sum(self.cell.reference.objective(p, self._data(dtype), noise,
                                                      matmul=matmul))
        keys = sorted(p)
        grad = dict(zip(keys, torch.autograd.grad(-val, [p[k] for k in keys])))
        step = {}
        for k in keys:
            m, v, t = last["state"][k]
            step[k] = adam_update(grad[k], m.to(dtype).reshape(shape[k]),
                                  v.to(dtype).reshape(shape[k]), t,
                                  self.cell.config["learning_rate"])[2]
        return {"loss": float(val.detach()), "grad": grad, "step": step}

    def readings(self, control=None):
        """The program's first three steps and its window's last against
        the float64 reference from the same inputs and state; with
        ``control="tf32_reference"``, the reference's own in float32 with
        TF32 products in the program's place."""
        from ..reference.common import tf32_matmul

        ref = self._reference_steps(torch.float64)
        if control == "tf32_reference":
            prog = self._reference_steps(torch.float32, tf32_matmul)
        else:
            prog = dict(self.prog, p0=ref["p0"])
        self.detail = checks.fit_detail(prog, ref, self.batched)
        out = checks.fit_readings(prog, ref, self.batched)
        if self.last is not None:
            ref_last = self._reference_last(torch.float64)
            if control == "tf32_reference":
                prog_last = self._reference_last(torch.float32, tf32_matmul)
            else:
                prog_last = {"loss": self.last["loss"], "grad": self.last["grad"],
                             "step": {k: self.last["after"][k].double()
                                      - self.last["before"][k].double()
                                      for k in self.last["before"]}}
            out.update(checks.last_readings(prog_last, ref_last, self.batched))
        return out
