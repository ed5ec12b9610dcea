"""joint_vae_tpu_torch — the PyTorch/CUDA port of ``joint_vae_tpu``.

It serves a trained joint/conditional VAE (per-class evaluation, OOD
scores and the calibrated accept gate: ``serve.py``, ``cli/serve.py``) and
trains one (``train/``: the train step, the optimizer, ``train_model``),
reading and writing the JAX package's job directories.  Compute runs on an
NVIDIA Hopper card; the two hot spots are hand-written CUDA kernels under
``csrc/`` (``ops/same_grid_conv.py``, also for the conv's input gradient,
and ``ops/iws.py``), each with a plain PyTorch version beside it that the
CPU path and the tests use.

The package imports torch and numpy only — never jax, flax, optax or the
JAX package it is held against.
"""
