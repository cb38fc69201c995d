from . import kernels
from .gp import GP, SparseGP
