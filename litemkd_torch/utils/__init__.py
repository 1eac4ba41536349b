from .metrics import per_episode_accuracy, confidence_interval, TestAccuracies
from .logging import MetricsLogger

__all__ = ["per_episode_accuracy", "confidence_interval", "TestAccuracies",
           "MetricsLogger"]
