from .fusion import (Encoder, EncoderLayer, MFMTeacher, MultiStreamFusion,
                     SelfAttention, ThreeStreamFusion, TrxBranch,
                     TwoStreamFusion, init_mfm_)

__all__ = ["Encoder", "EncoderLayer", "MFMTeacher", "MultiStreamFusion",
           "SelfAttention", "ThreeStreamFusion", "TrxBranch",
           "TwoStreamFusion", "init_mfm_"]
