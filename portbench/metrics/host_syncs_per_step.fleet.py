"""Host waits on the card a fleet step (driver)."""
from portbench.metrics import _common

MOVES = "fleet_steps_per_s"
UNIT = "syncs/step"
read = _common.host_syncs_per_step
