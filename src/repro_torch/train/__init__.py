"""Training: optimizers, checkpoints, the loop and the LeNet trainer."""
