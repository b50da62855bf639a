"""Measurement scripts of the port, run on a CUDA card from the repo root
(``python3 -m paddle_tpu_torch.tools.<name>``)."""
