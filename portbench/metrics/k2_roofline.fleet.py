"""K2's share of its roofline in the fleet (hand kernels)."""
from portbench.metrics import _common

MOVES = "fleet_steps_per_s"
UNIT = "%"
read = _common.k2_roofline
