"""Device operations a fleet step (model step)."""
from portbench.metrics import _common

MOVES = "fleet_steps_per_s"
UNIT = "ops/step"
read = _common.device_ops_per_step
