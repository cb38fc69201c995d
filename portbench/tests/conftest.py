"""Fixtures of the benchmark's CPU tests: tiny cells in a copy of the
benchmark's data files, and the card for the tests that need one.

Run: ``python -m pytest portbench/tests`` from the repository root; the
``cuda`` tests run where torch finds a card and skip elsewhere."""
import json
import os
import shutil
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import spec  # noqa: E402

FIT_LIMITS = {"loss_gap": 1e-3, "grad_gap": 1e-2, "step_gap": 1e-2,
              "last_loss_gap": 1e-3, "last_grad_gap": 1e-2, "last_step_gap": 1e-2}
TINY = {
    # name: (config, traffic file contents, limits)
    "tiny.fleet": ("gpr_n40", {"driver": "fit", "models": 4, "warmup_steps": 2,
                                   "window_steps_per_s": 40}, FIT_LIMITS),
    "tiny.exact": ("gpr_exact", {"driver": "fit", "models": 1, "n": 64, "warmup_steps": 2,
                                   "window_steps_per_s": 40},
                   FIT_LIMITS),
    "tiny.serve": ("gpr_exact",
                   {"driver": "serve", "n": 64,
                    "requests": {"set_size": 8, "min_points": 1, "max_points": 16,
                                 "low": 0.0, "high": 6.0}},
                   {"mean_gap": 1e-3, "var_gap": 1e-3}),
}


def write_cell(root, name, config, traffic, limits, chips=1):
    """A cell as the files a later change would add: its traffic and its
    workload."""
    tname = name.replace(".", "_")
    with open(os.path.join(root, "traffic", tname + ".json"), "w") as f:
        json.dump(traffic, f)
    with open(os.path.join(root, "workloads", name + ".json"), "w") as f:
        json.dump({"config": config, "traffic": tname, "chips": chips, "why": "a test",
                   "limits": limits}, f)


@pytest.fixture
def tiny_root(tmp_path, monkeypatch):
    """A copy of the benchmark's data files and metric readers with the
    tiny cells added, in place of ``portbench/``'s own."""
    for kind in ("configs", "traffic", "workloads", "metrics"):
        shutil.copytree(os.path.join(spec.ROOT, kind), tmp_path / kind)
    for name, (config, traffic, limits) in TINY.items():
        write_cell(str(tmp_path), name, config, traffic, limits)
    monkeypatch.setattr(spec, "ROOT", str(tmp_path))
    torch.set_num_threads(min(4, torch.get_num_threads()))
    return tmp_path


@pytest.fixture
def card():
    """Skips where torch finds no CUDA card (decided here, never at
    import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
