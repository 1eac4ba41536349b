from .synthetic import SyntheticEpisodeSource
from .splits import SplitIndex, VideoRecord, load_split_lists
from .video import (VideoStore, ZipFrameStore, scan_frame_tree,
                    sample_frame_indices, load_clip)
from .features import FeatureStore, MultiModalFeatureStore, scan_feature_tree
from .episodes import (EpisodeMeta, EpisodeSampler, EpisodeSpec,
                       draw_episode_spec, load_fixed_episodes,
                       load_reference_fixed_episodes, save_fixed_episodes,
                       save_reference_fixed_episodes)
from .prefetch import DeferredHostSync, Prefetcher
from .multimodal import MultiModalEpisodeSampler

__all__ = ["SyntheticEpisodeSource", "SplitIndex", "VideoRecord",
           "load_split_lists", "VideoStore", "ZipFrameStore",
           "scan_frame_tree", "sample_frame_indices", "load_clip",
           "FeatureStore", "MultiModalFeatureStore", "scan_feature_tree",
           "EpisodeMeta", "EpisodeSampler", "EpisodeSpec", "draw_episode_spec",
           "load_fixed_episodes", "load_reference_fixed_episodes",
           "save_fixed_episodes", "save_reference_fixed_episodes",
           "DeferredHostSync", "Prefetcher", "MultiModalEpisodeSampler"]
