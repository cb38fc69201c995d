"""Host waits on the card a step of one model's fit (driver)."""
from portbench.metrics import _common

MOVES = "fit_steps_per_s"
UNIT = "syncs/step"
read = _common.host_syncs_per_step
