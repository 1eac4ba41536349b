from .positional import SinusoidalPE, sinusoidal_pe
from .tuples import tuple_indices, gather_tuples
from .tct import TemporalCrossTransformer, class_sort
from .distances import support_dk_logits

__all__ = [
    "SinusoidalPE", "sinusoidal_pe", "tuple_indices", "gather_tuples",
    "TemporalCrossTransformer", "class_sort", "support_dk_logits",
]
