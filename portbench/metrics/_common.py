"""What the readers compute, each a function of the traced windows'
digest (``tracing.py``, a driver's ``traced()``). A reader file names the
end-to-end metric it moves; ``run.py`` asks only the readers whose metric
the cell reports, so one computation serves a ``.fit`` and a ``.fleet``
reader alike."""
from __future__ import annotations

import math

from portbench import roofline


def batch_of(shape):
    """The product of a shape's leading axes (all but the last two)."""
    return math.prod(shape[:-2]) if len(shape) > 2 else 1


def kernel_roofline(trace, op_name, kernel_part, cost):
    """100 x (the least time of the host operations named `op_name`, by
    `cost(shapes)` -> (bytes, flops), or None for a call that launches no
    such kernel) / (the device time of the kernels whose name holds
    `kernel_part`), from the host window; None when the window holds none,
    or the calls and the kernels do not pair one to one."""
    host = trace.get("host")
    if not host:
        return None
    costs = [cost(shapes) for name, shapes, _ in host["ops"] if name == op_name]
    costs = [c for c in costs if c is not None]
    times = [s for name, s in host["kernels"] if kernel_part in name]
    if not costs or len(costs) != len(times) or sum(times) <= 0:
        return None
    least = sum(roofline.bound_s(b, f)[0] for b, f in costs)
    return 100.0 * least / sum(times)


def _chol(shapes):
    A = shapes[0]
    return roofline.chol_cost(batch_of(A), A[-1])


def _solve(shapes, max_m=128):
    L, R = shapes[0], shapes[1]
    if not 0 < R[-1] <= max_m:  # past 128 columns the op calls torch.linalg
        return None
    return roofline.solve_cost(batch_of(L), L[-1], R[-1])


def k1_roofline(trace):
    """K1: ``roofline.chol_cost`` at each ``cholesky128`` call's batch and
    n, over the ``chol128`` kernels' device time."""
    return kernel_roofline(trace, "henbun_tpu_torch::cholesky128", "chol128", _chol)


def k2_roofline(trace):
    """K2: ``roofline.solve_cost`` at each ``tri_solve128`` call's batch,
    n and m, over the ``trisolve128`` kernels' device time."""
    return kernel_roofline(trace, "henbun_tpu_torch::tri_solve128", "trisolve128", _solve)


def mfu(trace):
    """The step's operations as its inputs need them (``step_flops``)
    times the traced chunk's steps, over its seconds x 67 TFLOP/s."""
    if not trace.get("step_flops"):
        return None
    return 100.0 * trace["step_flops"] * trace["work"] / (
        trace["window_s"] * roofline.FP32_FLOP_PER_S)


def idle_share(trace):
    """100 x (1 - the union of the device operations' intervals over the
    device window's length)."""
    if trace["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])


def device_ops_per_step(trace):
    """Device operations (kernels, copies, sets) of the traced chunk over
    its steps."""
    return len(trace["device_ops"]) / trace["work"] if trace["device_ops"] else None


def host_syncs_per_step(trace):
    """Sync debug mode's count over a chunk of 9 steps less its count over
    3, over 6, so that what a chunk does once drops out."""
    return trace.get("syncs_per_step")


def device_ms_per_call(trace):
    """The union of the device window's operations over its served calls."""
    return 1e3 * trace["busy_s"] / trace["work"] if trace["busy_s"] > 0 else None
