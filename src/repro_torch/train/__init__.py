"""Training: optimizer, train step, gradient compression, checkpoints and
straggler monitoring."""
