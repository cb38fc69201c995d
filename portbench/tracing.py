"""The probes of a ``--trace 1`` run, each started and stopped around a
short window of the cell's own work after the warm-up (a driver may start
and stop one from inside the program's callback):

* ``DeviceTrace``: torch.profiler with the card's activity only, so the
  wall clock is the program's own: the busy time (the union of the device
  operations' intervals), the window's length, and each device operation.
* ``HostTrace``: the host's operations too, with their input shapes: the
  kernel calls' shapes for the rooflines, the device time each host
  operation launched, and what the host was doing in each idle gap.
* ``SyncCount``: torch.cuda's sync debug mode counts the operations that
  make the host wait for the card.
"""
from __future__ import annotations

import time
import warnings

import numpy as np
import torch

NAME_CHARS = 120


def _device_events(prof):
    """Kernels, copies and sets: the card's activity, not the ranges that
    annotations project onto it."""
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def _union_us(intervals):
    """Total length of the union of (start, end) intervals, and the gaps
    between them [(start, end)], in the profiler's microseconds."""
    total, gaps, cur = 0.0, [], None
    for s, e in sorted(intervals):
        if cur is None:
            cur = [s, e]
        elif s > cur[1]:
            total += cur[1] - cur[0]
            gaps.append((cur[1], s))
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    if cur is not None:
        total += cur[1] - cur[0]
    return total, gaps


class DeviceTrace:
    """torch.profiler with the card's activity only, between ``start()``
    and ``stop()``; ``result()``: {"window_s", "busy_s", "device_ops":
    [(name, seconds)]}."""

    def start(self):
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        self.t0 = time.perf_counter()

    def stop(self):
        torch.cuda.synchronize()
        self.window = time.perf_counter() - self.t0
        self.prof.stop()

    def result(self):
        events = _device_events(self.prof)
        busy_us, _ = _union_us([(e.time_range.start, e.time_range.end) for e in events])
        return {"window_s": self.window, "busy_s": busy_us / 1e6,
                "device_ops": [(e.name[:NAME_CHARS], e.time_range.elapsed_us() / 1e6)
                               for e in events]}


def _device_time_us(e):
    for attr in ("device_time_total", "cuda_time_total"):
        v = getattr(e, attr, None)
        if v is not None:
            return float(v)
    return 0.0


class HostTrace:
    """torch.profiler with host and card activity and input shapes, between
    ``start()`` and ``stop()``; ``result()``: {"ops": [(name, input shapes,
    device seconds it launched)], "kernels": [(name, seconds)],
    "idle_by_host": [(host operation, seconds of idle card)]}, the last
    over the longest `gaps_kept` gaps, each put down to the host operation
    that overlaps it most (the shortest such, where several cover it)."""

    def __init__(self, gaps_kept=500):
        self.gaps_kept = gaps_kept

    def start(self):
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                            record_shapes=True)
        self.prof.start()

    def stop(self):
        torch.cuda.synchronize()
        self.prof.stop()

    def result(self):
        events = self.prof.events()
        dev = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
        host = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU]
        ops = [(e.name, [list(s) if isinstance(s, (list, tuple)) else s
                         for s in (getattr(e, "input_shapes", None) or [])],
                _device_time_us(e) / 1e6) for e in host]
        kernels = [(e.name[:NAME_CHARS], e.time_range.elapsed_us() / 1e6) for e in dev]
        _, gaps = _union_us([(e.time_range.start, e.time_range.end) for e in dev])
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:self.gaps_kept]
        idle = {}
        if host and gaps:
            starts = np.array([e.time_range.start for e in host], dtype=np.float64)
            ends = np.array([e.time_range.end for e in host], dtype=np.float64)
            for g0, g1 in gaps:
                overlap = np.minimum(ends, g1) - np.maximum(starts, g0)
                score = overlap - 1e-9 * (ends - starts)
                i = int(np.argmax(score))
                label = host[i].name[:NAME_CHARS] if overlap[i] > 0 else "(no host operation)"
                idle[label] = idle.get(label, 0.0) + (g1 - g0) / 1e6
        return {"ops": ops, "kernels": kernels,
                "idle_by_host": sorted(idle.items(), key=lambda kv: -kv[1])}


class SyncCount:
    """The number of synchronizing operations (host reads of device values,
    device-to-host and pageable host-to-device copies) between ``start()``
    and ``stop()``, counted from torch.cuda's sync debug mode warnings (as
    ``chip_smoke.host_reads``)."""

    def start(self):
        self._cm = warnings.catch_warnings(record=True)
        self._caught = self._cm.__enter__()
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")

    def stop(self):
        try:
            torch.cuda.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode("default")
            self._cm.__exit__(None, None, None)

    def result(self):
        return sum("synchroniz" in str(w.message) for w in self._caught)


def over(probe, run):
    """`probe` started before `run()` and stopped after it; its result."""
    probe.start()
    try:
        run()
    finally:
        probe.stop()
    return probe.result()


def top(pairs, k=10):
    """The k largest [name, seconds], summed by name."""
    acc = {}
    for name, s in pairs:
        acc[name] = acc.get(name, 0.0) + s
    return [[n, s] for n, s in sorted(acc.items(), key=lambda kv: -kv[1])[:k]]
