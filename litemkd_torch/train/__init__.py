from .steps import EpisodeBatch, make_eval_step
from .loop import run_eval

__all__ = ["EpisodeBatch", "make_eval_step", "run_eval"]
