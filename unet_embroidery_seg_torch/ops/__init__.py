"""Kernels and tensor ops of the port; ``ops/_build.py`` builds the CUDA sources in ``csrc/``."""
