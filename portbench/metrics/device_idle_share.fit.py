"""The card's idle share while one model fits (device)."""
from portbench.metrics import _common

MOVES = "fit_steps_per_s"
UNIT = "%"
read = _common.idle_share
