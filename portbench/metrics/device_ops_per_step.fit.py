"""Device operations a step of one model's fit (model step)."""
from portbench.metrics import _common

MOVES = "fit_steps_per_s"
UNIT = "ops/step"
read = _common.device_ops_per_step
