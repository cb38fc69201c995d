"""Native (C++) data path: the out-of-core prefetching loader and the
streaming trainer."""
from . import loader, streaming
from .loader import OutOfCoreLoader, write_dataset, read_columns
from .streaming import optimize_streaming
