"""The serve driver: a configuration's predictor exported with
``serving.export_predictor`` for the card (one symbolic request size),
and one client in a closed loop: each request is sent when the answer to
the last one is back on the host.

Set-up builds the data and the model at hyperparameters drawn from the
seed (no fit), exports the predictor, calls it once at every request size
the traffic uses, and draws the requests. A request's latency runs from
its send (host points in) to its answer on the host; the tails are over
every request of the window, a failed request counting as missing.

Traffic keys: ``n`` (the training set), ``requests`` (``set_size``,
``min_points``, ``max_points``: a fixed set of log-uniform sizes, each
pass over it in an order drawn from the seed; ``low``, ``high``: the
points' U[low, high]), ``trace_window_s``, ``host_window_s``.
"""
from __future__ import annotations

import gc
import math
import sys
import time

import numpy as np
import torch

from .. import data, tracing

REFERENCE_BLOCK = 16384  # request points the reference takes at once


def _worst(so_far, got, want, scale):
    """The larger of `so_far` and max |got - want| / scale; infinite where
    the shapes differ or a gap is not a number."""
    if got.shape != want.shape:
        return math.inf
    gap = float(torch.max(torch.abs(got.double() - want))) / scale
    return math.inf if gap != gap else max(so_far, gap)


class Driver:
    def __init__(self, cell, seed, device):
        self.cell, self.seed, self.device = cell, int(seed), torch.device(device)
        self.n = int(cell.traffic["n"])
        self.e2e = {"predict_ms_p50": "ms", "predict_ms_p95": "ms"}  # end-to-end: unit

    # ---------------------------------------------------------------- set-up
    def setup(self):
        import henbun_tpu_torch as hb
        from henbun_tpu_torch import models, serving

        cfg, tr, dev = self.cell.config, self.cell.traffic, self.device
        hb.set_seed(data.subseed(self.seed, "host"))
        X, Y = data.regression_data(cfg["data"], 1, self.n,
                                    data.generator(self.seed, "data", dev), dev)
        self.X, self.Y = X[0], Y[0]
        cls = getattr(models, cfg["model"])
        m = cls(seed=0, X=self.X.cpu().numpy(), Y=self.Y.cpu().numpy(), device=dev,
                **cfg.get("model_kwargs", {}))
        shapes = {k: tuple(v.shape) for k, v in m.param_dict().items()}
        self.init = {k: v[0] for k, v in data.free_values(
            cfg["init"], shapes, 1, data.generator(self.seed, "init", dev), dev).items()}
        m.set_param_dict({k: v.cpu().numpy() for k, v in self.init.items()})
        example = np.linspace(0.0, 6.0, 8, dtype=np.float32)[:, None]
        self.art = serving.export_predictor(m, getattr(cls, cfg["predictor"]), example,
                                            platforms=(dev.type,), batch_polymorphic=True)
        del m
        self.req_spec = tr["requests"]
        self.g = data.generator(self.seed, "requests", dev)
        # every request size the traffic sends, once
        sizes = sorted(set(data.request_sizes(self.req_spec, int(self.req_spec["set_size"]),
                                              self.g)))
        t0 = time.perf_counter()
        for b in sizes:
            self._call(self._points([b])[0])
        self.latency = (time.perf_counter() - t0) / len(sizes)

    def _points(self, sizes):
        """Host request points [b, 1] float32, U[low, high], for each size."""
        spec = self.req_spec
        total = int(sum(sizes))
        x = spec["low"] + (spec["high"] - spec["low"]) * torch.rand(
            total, generator=self.g, device=self.g.device)
        x = x.cpu().numpy()[:, None]
        return np.split(x, np.cumsum(sizes)[:-1])

    def _call(self, x):
        mean, var = self.art(x)
        return mean.cpu().numpy(), var.cpu().numpy()

    def _stream(self, seconds):
        """Enough requests for `seconds` at half the warm-up latency, in
        whole passes over the size set."""
        k = int(self.req_spec["set_size"])
        count = k * max(1, math.ceil(2.0 * seconds / self.latency / k))
        sizes = data.request_sizes(self.req_spec, count, self.g)
        return self._points(sizes)

    # ----------------------------------------------------------------- window
    def window(self, seconds):
        """The closed loop for `seconds`: ({predict_ms_p50, predict_ms_p95},
        attempted, failed)."""
        reqs = self._stream(seconds)
        lat, self.answers, failed = [], [], 0
        t_end = time.perf_counter() + seconds
        i = 0
        while time.perf_counter() < t_end:
            x = reqs[i % len(reqs)]
            t0 = time.perf_counter()
            try:
                mean, var = self._call(x)
            except Exception as exc:  # a failed request counts as missing
                failed += 1
                lat.append(math.inf)
                print("request %d (%d points) failed: %r" % (i, len(x), exc), file=sys.stderr)
            else:
                lat.append(time.perf_counter() - t0)
                self.answers.append((x, mean, var))
            i += 1
        ms = 1e3 * np.asarray(lat)
        return ({"predict_ms_p50": float(np.percentile(ms, 50)),
                 "predict_ms_p95": float(np.percentile(ms, 95))}, len(lat), failed)

    def traced(self):
        tr = self.cell.traffic
        reqs = self._stream(float(tr.get("trace_window_s", 2.0)))
        self.answers = []
        k = max(1, int(round(float(tr.get("trace_window_s", 2.0)) / self.latency)))
        kh = max(1, int(round(float(tr.get("host_window_s", 0.5)) / self.latency)))

        def run(count):
            for i in range(count):
                x = reqs[i % len(reqs)]
                self.answers.append((x,) + self._call(x))

        digest = tracing.over(tracing.DeviceTrace(), lambda: run(k))
        digest["host"] = tracing.over(tracing.HostTrace(), lambda: run(kh))
        digest["host"]["work"] = kh
        digest.update(driver="serve", work=k)
        return digest, k

    # ------------------------------------------------------------ correctness
    def release(self):
        self.art = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def readings(self):
        """Every answer of the window against the float64 reference's."""
        from ..reference.common import positive

        ref = self.cell.reference.Predictor(
            {k: v.double() for k, v in self.init.items()},
            {"X": self.X.double(), "Y": self.Y.double()})
        k_var = float(positive(self.init["k_var"].double())[0])
        mean_gap = var_gap = 0.0 if self.answers else math.inf
        block = []

        def flush():
            nonlocal mean_gap, var_gap
            x = torch.as_tensor(np.concatenate([a[0] for a in block]), device=self.device)
            m_ref, v_ref = ref(x.double())
            m = torch.as_tensor(np.concatenate([a[1] for a in block]), device=self.device)
            v = torch.as_tensor(np.concatenate([a[2] for a in block]), device=self.device)
            mean_gap = _worst(mean_gap, m, m_ref, math.sqrt(k_var))
            var_gap = _worst(var_gap, v, v_ref, k_var)
            block.clear()

        points = 0
        for a in self.answers:
            if block and points + len(a[0]) > REFERENCE_BLOCK:
                flush()
                points = 0
            block.append(a)
            points += len(a[0])
        if block:
            flush()
        return {"mean_gap": mean_gap, "var_gap": var_gap}
