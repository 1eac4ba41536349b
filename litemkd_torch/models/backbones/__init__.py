from .classifier_net import ActionRecognitionNet, ViTClassifier
from .resnet import (BasicBlock, Bottleneck, ResNetBackbone, ResNetTrunk,
                     adaptive_max_pool_2d)
from .strm import STRMBackbone

__all__ = ["ActionRecognitionNet", "BasicBlock", "Bottleneck", "ResNetBackbone",
           "ResNetTrunk", "STRMBackbone", "ViTClassifier", "adaptive_max_pool_2d"]
