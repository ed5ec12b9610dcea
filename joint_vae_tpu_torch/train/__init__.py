"""Training: optimizer, train state, steps and the trainer."""
