"""Ops of the port: attention, conv, pool and batch norm (nn_ops.py), the
conv-efficiency ops with the fused 1x1 conv kernel (pallas_conv.py), the
CUDA kernels' build (_build.py), the training path's loss (loss_ops.py)
and optimizer updates (optimizer_ops.py)."""
