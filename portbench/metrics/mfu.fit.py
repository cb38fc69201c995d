"""One model's fit step's share of the float32 peak (device)."""
from portbench.metrics import _common

MOVES = "fit_steps_per_s"
UNIT = "%"
read = _common.mfu
