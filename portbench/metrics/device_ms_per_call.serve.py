"""Device time of the exported program a served call (serving)."""
from portbench.metrics import _common

MOVES = "predict_ms_p95"
UNIT = "ms"
read = _common.device_ms_per_call
