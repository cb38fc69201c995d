"""Prebuilt model families: GP regression and binary GP classification."""
from .gpr import GPR, GPRMarginal, make_sine_dataset
from .gpc import GPC
