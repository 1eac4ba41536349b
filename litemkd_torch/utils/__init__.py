from .metrics import per_episode_accuracy, confidence_interval, TestAccuracies

__all__ = ["per_episode_accuracy", "confidence_interval", "TestAccuracies"]
