"""Models of the port: the causal LM the decode engine serves, BERT
pretraining and ResNet (resnet.py)."""
from .resnet import (ResNet, ResNet18, ResNet34, ResNet50, ResNet101,
                     ResNet152)

__all__ = ['ResNet', 'ResNet18', 'ResNet34', 'ResNet50', 'ResNet101',
           'ResNet152']
