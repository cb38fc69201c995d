"""The fleet step's share of the float32 peak (device)."""
from portbench.metrics import _common

MOVES = "fleet_steps_per_s"
UNIT = "%"
read = _common.mfu
