from .edist import CosDistance, EDist, EDist1FCSup, EDistFC2, EDistFC2Sup
from .strm import STRM1FCSup, STRMClassifier, STRMClassifierSup
from .trx import TRX, TRX_2fcsup, TRX_2fcsup_fixed

__all__ = ["CosDistance", "EDist", "EDist1FCSup", "EDistFC2", "EDistFC2Sup",
           "STRM1FCSup", "STRMClassifier", "STRMClassifierSup", "TRX",
           "TRX_2fcsup", "TRX_2fcsup_fixed"]
