from .synthetic import SyntheticEpisodeSource
from .splits import SplitIndex, VideoRecord, load_split_lists
from .features import FeatureStore, MultiModalFeatureStore, scan_feature_tree
from .episodes import EpisodeSpec, draw_episode_spec
from .multimodal import MultiModalEpisodeSampler

__all__ = ["SyntheticEpisodeSource", "SplitIndex", "VideoRecord",
           "load_split_lists", "FeatureStore", "MultiModalFeatureStore",
           "scan_feature_tree", "EpisodeSpec", "draw_episode_spec",
           "MultiModalEpisodeSampler"]
