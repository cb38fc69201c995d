"""`hb.param` API surface: re-exports the parameter-tree core."""
from .core.param import (
    graph_key,
    Parentable,
    Variable,
    Parameterized,
    ParamList,
    Data,
    MinibatchData,
)
