from .synthetic import SyntheticEpisodeSource

__all__ = ["SyntheticEpisodeSource"]
