from .positional import (Dropout, SinusoidalPE, TrainablePE, sinusoidal_pe,
                         bind_dropout_generator)
from .tuples import tuple_indices, gather_tuples
from .tct import MultiSetTCT, TemporalCrossTransformer, class_sort
from .distances import support_dk_logits

__all__ = [
    "Dropout", "SinusoidalPE", "TrainablePE", "sinusoidal_pe",
    "bind_dropout_generator", "tuple_indices", "gather_tuples",
    "MultiSetTCT", "TemporalCrossTransformer", "class_sort",
    "support_dk_logits",
]
