from .ctx import CTXClassifier, CTXVideoAxis
from .edist import CosDistance, EDist, EDist1FCSup, EDistFC2, EDistFC2Sup
from .otam import OTAMClassifier, TRXMulti
from .strm import STRM1FCSup, STRMClassifier, STRMClassifierSup
from .trx import (TRX, TRX_1fc_sup, TRX_2fc, TRX_2fcsup, TRX_2fcsup_2,
                  TRX_2fcsup_fixed, TRX_sup)

__all__ = ["CTXClassifier", "CTXVideoAxis", "CosDistance", "EDist",
           "EDist1FCSup", "EDistFC2", "EDistFC2Sup", "OTAMClassifier",
           "STRM1FCSup", "STRMClassifier", "STRMClassifierSup", "TRX",
           "TRXMulti", "TRX_1fc_sup", "TRX_2fc", "TRX_2fcsup", "TRX_2fcsup_2",
           "TRX_2fcsup_fixed", "TRX_sup"]
