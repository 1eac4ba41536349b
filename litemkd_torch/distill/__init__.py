from .losses import merge_logits

__all__ = ["merge_logits"]
