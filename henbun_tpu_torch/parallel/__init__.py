"""Multi-card scaling over ``torch.distributed``: device meshes, sharded
training, chain-sharded samplers."""
from . import mesh
from .mesh import make_mesh, DATA_AXIS, CHAIN_AXIS, initialize_distributed
from .sharding import ShardedOptimizer, ShardedBatchedOptimizer
