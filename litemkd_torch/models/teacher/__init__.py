from .fusion import (BatchStatFusion, CrossAttentionFusion, DGAdaIN,
                     DGAFusionTeacher, Encoder, EncoderLayer, MFMTeacher,
                     MultiStreamFusion, ScoreFusion, SelfAttention,
                     SelfEncoderBranch, ThreeStreamFusion, TrxBranch,
                     TwoRoadFusionTeacher, TwoStreamFusion, init_mfm_)
from .composer import (Branch, ComposedFusionTeacher, PRESETS as FUSION_PRESETS,
                       PRESET_OPTIONS as FUSION_PRESET_OPTIONS,
                       PRESET_EXTRACT as FUSION_PRESET_EXTRACT,
                       PRESET_MODULES as FUSION_PRESET_MODULES)

__all__ = ["BatchStatFusion", "CrossAttentionFusion", "DGAdaIN",
           "DGAFusionTeacher", "Encoder", "EncoderLayer", "MFMTeacher",
           "MultiStreamFusion", "ScoreFusion", "SelfAttention",
           "SelfEncoderBranch", "ThreeStreamFusion", "TrxBranch",
           "TwoRoadFusionTeacher", "TwoStreamFusion", "init_mfm_", "Branch",
           "ComposedFusionTeacher", "FUSION_PRESETS", "FUSION_PRESET_OPTIONS",
           "FUSION_PRESET_EXTRACT", "FUSION_PRESET_MODULES"]
