from .student import (Student, BatchedStudent, BACKBONES, CLASSIFIERS,
                      make_backbone, make_classifier)
from .backbones.resnet import ResNetBackbone, ResNetTrunk, adaptive_max_pool_2d

__all__ = ["Student", "BatchedStudent", "BACKBONES", "CLASSIFIERS",
           "make_backbone", "make_classifier", "ResNetBackbone", "ResNetTrunk",
           "adaptive_max_pool_2d"]
