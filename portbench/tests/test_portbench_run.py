"""A run's last line, the refusal without a card, and the guard that the
benchmark loads neither JAX nor the JAX package."""
import json
import math
import os
import subprocess
import sys
import time

import pytest
import torch
from conftest import ROOT

from portbench import run

DEVICE_KEYS = {"platform", "kind", "count"}


@pytest.mark.parametrize("name", ["tiny.fleet", "tiny.exact", "tiny.serve"])
def test_last_line_schema(tiny_root, name, capsys):
    result = run.run_cell(name, 2 ** 31 + 7, 0.5, 0, device="cpu", t_start=time.perf_counter())
    line = json.loads(json.dumps(result))
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    assert DEVICE_KEYS <= set(line["device"])
    e2e = {"fit_steps_per_s"} if "serve" not in name else {"predict_ms_p50", "predict_ms_p95"}
    assert set(line["metrics"]) == e2e | {"setup_s"}
    for m in line["metrics"].values():
        assert math.isfinite(m["value"]) and m["value"] > 0 and m["unit"]
    for c in line["checks"].values():
        assert c["value"] <= c["limit"]
    err = capsys.readouterr().err.strip().splitlines()
    assert [ln.split()[1] for ln in err[-len(line["checks"]):]] == sorted(line["checks"])


def test_same_seed_same_inputs(tiny_root):
    from portbench import spec

    cell = spec.Cell("tiny.fleet")
    a, b = (cell.driver.Driver(cell, 99, "cpu") for _ in range(2))
    for d in (a, b):
        d.setup()
    assert torch.equal(a.Y, b.Y) and all(torch.equal(a.init[k], b.init[k]) for k in a.init)
    assert all(torch.equal(a.noise_log[0][k], b.noise_log[0][k]) for k in a.noise_log[0])


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, os.path.join(ROOT, "portbench", "run.py"),
                          "--workload", "gpr_n40.fleet8192", "--seed", "1", "--seconds", "1"],
                         capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode != 0 and out.stdout == ""


def test_loads_neither_jax_nor_the_jax_package():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import runpy\n"
        "runpy.run_path(%r, run_name='not_main')\n"
        "import henbun_tpu_torch, henbun_tpu_torch.serving, henbun_tpu_torch.batched\n"
        "from portbench import spec, calibrate, faults, tracing\n"
        "for name in spec.names('workloads'):\n"
        "    c = spec.Cell(name); c.driver; c.reference\n"
        "spec.metric_readers()\n"
        "import portbench.run as r\n"
        "print(','.join(r.forbidden_modules()))\n"
        "print(sorted(n for n in sys.modules if n.split('.')[0] == 'henbun_tpu_torch')[:1])\n"
    ) % (ROOT, os.path.join(ROOT, "portbench", "run.py"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    forbidden, torch_port = out.stdout.rstrip("\n").split("\n")
    assert forbidden == ""
    assert torch_port == "['henbun_tpu_torch']"


def test_reference_imports_nothing_of_the_program():
    folder = os.path.join(ROOT, "portbench", "reference")
    for f in os.listdir(folder):
        if f.endswith(".py"):
            with open(os.path.join(folder, f)) as fh:
                src = fh.read()
            assert "import henbun" not in src and "from henbun" not in src
            assert "jax" not in src
