"""Ops of the port: attention, conv, pool, batch norm, softmax and dropout
(nn_ops.py), the conv-efficiency ops with the fused 1x1 conv kernel
(pallas_conv.py), the CUDA kernels' build (_build.py), losses and metrics
(loss_ops.py), optimizer updates (optimizer_ops.py), elementwise math and
reductions (math_ops.py), tensor ops (tensor_ops.py) and the ops the IR
passes emit (fused_ops.py). Each op the static
graph runs is registered by name in registry.py."""
