from .resnet import ResNetBackbone, ResNetTrunk, BasicBlock, adaptive_max_pool_2d

__all__ = ["ResNetBackbone", "ResNetTrunk", "BasicBlock", "adaptive_max_pool_2d"]
