"""Training of the flagship model: losses, optimizers, steps, checkpoints and
the stage trainers."""
