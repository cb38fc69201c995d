"""Prebuilt model families: GP regression and binary GP classification."""
from .gpr import GPR, make_sine_dataset
from .gpc import GPC
