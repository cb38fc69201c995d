from . import checkpoint, profiling
