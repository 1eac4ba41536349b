from .trx import TRX, TRX_2fcsup, TRX_2fcsup_fixed

__all__ = ["TRX", "TRX_2fcsup", "TRX_2fcsup_fixed"]
