"""``correct`` comes out false under each planted fault that a cell can
have, the harness's look for a card skipped and the rest of a run driven
on the CPU; and, on the card, under the control."""
import time

import pytest

from portbench import faults, run

CASES = [
    ("tiny.fleet", "frozen_state"), ("tiny.fleet", "half_batch"),
    ("tiny.exact", "frozen_state"), ("tiny.exact", "half_batch"),
    ("tiny.serve", "answer_altered"),
]


@pytest.mark.parametrize("name,fault", CASES)
def test_fault_is_not_correct(tiny_root, name, fault):
    with faults.planted(fault):
        result = run.run_cell(name, 11, 0.5, 0, device="cpu", t_start=time.perf_counter())
    assert result["correct"] is False


@pytest.mark.parametrize("name", ["tiny.fleet", "tiny.exact", "tiny.serve"])
def test_sound_run_is_correct(tiny_root, name):
    result = run.run_cell(name, 11, 0.5, 0, device="cpu", t_start=time.perf_counter())
    assert result["correct"] is True


@pytest.mark.parametrize("name", ["tiny.fleet", "tiny.exact"])
@pytest.mark.parametrize("fault", ["frozen_state", "half_batch"])
def test_fault_in_the_window_alone_is_not_correct(tiny_root, name, fault):
    """A fault that starts after set-up, so that only the window's steps
    carry it, fails the window's last step."""
    from portbench import checks, spec

    cell = spec.Cell(name)
    drv = cell.driver.Driver(cell, 12, "cpu")
    drv.setup()
    if fault == "half_batch":
        opt = drv.opt
        opt._evaluate_core_aux = faults._half(opt._evaluate_core_aux, drv.batched)
        drv.window(0.5)
    else:
        with faults.planted(fault):
            drv.window(0.5)
    drv.release()
    readings = drv.readings()
    first = {k: v for k, v in cell.limits.items() if not k.startswith("last_")}
    assert checks.judge(readings, first)[0] is True, readings
    assert checks.judge(readings, cell.limits)[0] is False, readings


def test_tf32_reference_control_reads_above_the_program(tiny_root):
    from portbench import spec

    cell = spec.Cell("tiny.fleet")
    drv = cell.driver.Driver(cell, 5, "cpu")
    drv.setup()
    drv.release()
    sound, control = drv.readings(), drv.readings(control="tf32_reference")
    assert control["grad_gap_median"] > 3 * sound["grad_gap_median"]


@pytest.mark.cuda
@pytest.mark.parametrize("name,control", [
    ("gpr_n40.fleet8192", "tf32_reference"),
    ("gpr_exact.n16384", "tf32"),
    ("gpr_exact.serve_n4096", "tf32"),
])
def test_control_is_not_correct_on_the_card(card, tiny_root, name, control):
    """The control at a size a test run holds (the cell's configuration and
    limits; a fleet of 512, n = 4096, a served n = 1024), on three seeds."""
    import json
    import os

    from conftest import write_cell

    from portbench import checks, spec

    cell = spec.Cell(name)
    traffic = dict(cell.traffic)
    traffic.update({"models": 512} if "fleet" in name else {"n": 1024 if "serve" in name
                                                              else 4096})
    small = name + "_small"
    write_cell(str(tiny_root), small, cell.workload["config"], traffic, cell.limits)
    with open(os.path.join(str(tiny_root), "workloads", small + ".json")) as f:
        assert json.load(f)["limits"] == cell.limits
    small_cell = spec.Cell(small)
    for seed in (1, 2, 3):
        with faults.planted(control):
            drv = small_cell.driver.Driver(small_cell, seed, card)
            drv.setup()
            drv.window(2.0)
            drv.release()
        readings = (drv.readings(control=control) if control == "tf32_reference"
                    else drv.readings())
        assert set(small_cell.limits) <= set(readings)
        assert checks.judge(readings, small_cell.limits)[0] is False, readings
