"""Numeric ops of the port: losses, sampling, sigma, priors, scores and
the two CUDA-kernel wrappers (``same_grid_conv``, ``iws``)."""
