"""Multi-card scaling over ``torch.distributed``: device meshes, sharded
training (with row-sharded full-batch evidence), chain-sharded samplers."""
from . import mesh, rows
from .mesh import make_mesh, DATA_AXIS, CHAIN_AXIS, initialize_distributed
from .rows import row_sharded
from .sharding import ShardedOptimizer, ShardedBatchedOptimizer
