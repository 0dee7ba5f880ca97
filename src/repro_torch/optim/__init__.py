"""Optimizers written out on tensors (``optim.adamw``)."""
