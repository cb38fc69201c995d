"""The card's idle share while one client is served (device)."""
from portbench.metrics import _common

MOVES = "predict_ms_p95"
UNIT = "%"
read = _common.idle_share
