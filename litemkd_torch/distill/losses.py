"""Logit merge rules for accuracy (port of
``litemkd_tpu/distill/losses.py:407-429``). The registry of distillation
losses belongs to the training path and is not ported yet."""
from __future__ import annotations


def merge_logits(distill_name: str, student_logits):
    """Combine a student's branch logits into the single (..., Q, way) matrix
    the accuracy metric consumes."""
    if isinstance(student_logits, dict):
        if distill_name == "support_sim":
            return student_logits["query"]
        if distill_name == "KL_feature":
            return student_logits["logits"]
        if "kl" in student_logits and "ce" in student_logits:
            return student_logits["kl"] + student_logits["ce"]
        if "fr1" in student_logits:  # strm_fc_2_sup_dist
            return (0.2 * student_logits["pat"] + student_logits["fr1"]
                    + student_logits["fr2"])
        if "fr" in student_logits:   # strm / strm_KD / strm_1fc_sup
            return 0.1 * student_logits["pat"] + student_logits["fr"]
        if "fc_1" in student_logits:
            return student_logits["fc_1"] + student_logits["fc_2"]
        if "kl" in student_logits:
            return student_logits["kl"]
        if "logits" in student_logits:
            return student_logits["logits"]
        raise KeyError(f"cannot merge logits dict with keys {list(student_logits)}")
    return student_logits
