"""Job directories, checkpoints and the weight bridge to the JAX package."""
