from .classifier_net import ActionRecognitionNet
from .resnet import (BasicBlock, Bottleneck, ResNetBackbone, ResNetTrunk,
                     adaptive_max_pool_2d)

__all__ = ["ActionRecognitionNet", "BasicBlock", "Bottleneck", "ResNetBackbone",
           "ResNetTrunk", "adaptive_max_pool_2d"]
