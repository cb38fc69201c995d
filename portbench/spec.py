"""Find a cell's files by name.

A cell (``workloads/<name>.json``) names its configuration
(``configs/<config>.json``) and its traffic mix (``traffic/<traffic>.json``);
the traffic names its driver (``drivers/<driver>.py``), the configuration
its plain reference (``reference/<config>.py``). A per-layer metric is
``metrics/<metric>.py``. Adding any of them is adding a file: nothing
here lists them.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import os

ROOT = os.path.dirname(os.path.abspath(__file__))


def _read(kind, name):
    path = os.path.join(ROOT, kind, name + ".json")
    if not os.path.exists(path):
        raise KeyError("no %s named %r (%s)" % (kind, name, path))
    with open(path) as f:
        return json.load(f)


def names(kind):
    """The names of the JSON files of one kind (``configs``, ``traffic``,
    ``workloads``), sorted."""
    return sorted(f[:-5] for f in os.listdir(os.path.join(ROOT, kind)) if f.endswith(".json"))


class Cell:
    """A workload with its configuration and traffic read in."""

    def __init__(self, name):
        self.name = name
        self.workload = _read("workloads", name)
        self.config = _read("configs", self.workload["config"])
        self.traffic = _read("traffic", self.workload["traffic"])

    @property
    def driver(self):
        return importlib.import_module("portbench.drivers." + self.traffic["driver"])

    @property
    def reference(self):
        return importlib.import_module("portbench.reference." + self.workload["config"])

    @property
    def limits(self):
        """{number compared: its limit}, from the workload file."""
        return dict(self.workload["limits"])


def metric_readers():
    """{metric name: module} for every ``metrics/<name>.py``. A reader has
    ``MOVES`` (the end-to-end metric it should move), ``UNIT`` and
    ``read(trace)``, which returns a number or None when the trace holds
    nothing it reads."""
    out = {}
    folder = os.path.join(ROOT, "metrics")
    for f in sorted(os.listdir(folder)):
        if not f.endswith(".py") or f.startswith("_"):
            continue
        name = f[:-3]
        spec = importlib.util.spec_from_file_location(
            "portbench_metric_" + name.replace(".", "_"), os.path.join(folder, f))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        out[name] = mod
    return out
