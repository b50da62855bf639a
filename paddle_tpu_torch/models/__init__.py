"""Models of the port: the causal LM the decode engine serves, BERT
pretraining, ResNet (resnet.py) and the vision models of vision.py
(MobileNet V1/V2, VGG, TSM and the DCGAN)."""
from .resnet import (ResNet, ResNet18, ResNet34, ResNet50, ResNet101,
                     ResNet152)
from .vision import (TSM, VGG, DCDiscriminator, DCGenerator, MobileNetV1,
                     MobileNetV2)

__all__ = ['ResNet', 'ResNet18', 'ResNet34', 'ResNet50', 'ResNet101',
           'ResNet152', 'MobileNetV1', 'MobileNetV2', 'VGG', 'TSM',
           'DCGenerator', 'DCDiscriminator']
