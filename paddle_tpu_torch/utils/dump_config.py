"""Configuration dump (counterpart of paddle_tpu/utils/dump_config.py):
prints the runtime configuration for a bug report."""
import os
import sys

__all__ = ['dump_config']

_ENV_PREFIXES = ('PADDLE_', 'FLAGS_', 'CUDA_', 'TORCH_', 'NVIDIA_')


def dump_config():
    """Print the python, torch and CUDA versions, the cards, TF32's state
    and the environment variables that steer the port."""
    import torch
    print('python:', sys.version.split()[0])
    print('torch:', torch.__version__)
    print('cuda:', torch.version.cuda, 'available',
          torch.cuda.is_available())
    for i in range(torch.cuda.device_count()):
        print('device:', i, torch.cuda.get_device_name(i))
    print('tf32: matmul', torch.backends.cuda.matmul.allow_tf32, 'cudnn',
          torch.backends.cudnn.allow_tf32)
    for k, v in sorted(os.environ.items()):
        if k.startswith(_ENV_PREFIXES):
            print(f'{k}={v}')
