"""Ops of the port: attention with hand-written CUDA kernels (nn_ops.py)
and their build (_build.py), the training path's loss (loss_ops.py) and
optimizer update (optimizer_ops.py)."""
