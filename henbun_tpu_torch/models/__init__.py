"""Prebuilt model families. This slice carries GP regression."""
from .gpr import GPR, make_sine_dataset
