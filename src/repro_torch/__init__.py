"""PyTorch/CUDA port of the AoT P-Tuning serving path (see README.md).

Imports torch and numpy, never JAX and never the ``repro`` package.
"""
