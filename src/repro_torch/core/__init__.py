"""Port of `repro.core`: the Basis Learn round engine on PyTorch.

The GLM path is float64 throughout (the reference enables JAX's x64 mode);
every tensor is created with an explicit dtype and device, and the global
default dtype is never changed.
"""
