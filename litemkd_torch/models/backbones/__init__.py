from .classifier_net import ActionRecognitionNet, ViTClassifier
from .mobilenet import MobileNetV3Backbone
from .resnet import (BasicBlock, Bottleneck, FeatureBackbone, ResNetBackbone,
                     ResNetTrunk, adaptive_max_pool_2d)
from .skeleton import SkeletonEncoder
from .strm import STRMBackbone

__all__ = ["ActionRecognitionNet", "BasicBlock", "Bottleneck", "FeatureBackbone",
           "MobileNetV3Backbone", "ResNetBackbone", "ResNetTrunk",
           "STRMBackbone", "SkeletonEncoder", "ViTClassifier",
           "adaptive_max_pool_2d"]
