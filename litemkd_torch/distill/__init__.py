from .losses import (kd_loss, softmax_ce, inter_class_relation,
                     pearson_correlation, get_distiller, available, register,
                     merge_logits)

__all__ = ["kd_loss", "softmax_ce", "inter_class_relation",
           "pearson_correlation", "get_distiller", "available", "register",
           "merge_logits"]
