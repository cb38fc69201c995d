"""The card's idle share while the fleet fits (device)."""
from portbench.metrics import _common

MOVES = "fleet_steps_per_s"
UNIT = "%"
read = _common.idle_share
