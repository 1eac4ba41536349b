from .steps import (EpisodeBatch, TrainState, create_train_state,
                    make_eval_step, make_train_step)
from .loop import run_eval, run_training, to_device
from .checkpoint import CheckpointManager, verify_checkpoint_dir
from .schedule import make_optimizer, lr_boundaries

__all__ = ["EpisodeBatch", "TrainState", "create_train_state",
           "make_eval_step", "make_train_step", "run_eval", "run_training",
           "to_device", "CheckpointManager", "verify_checkpoint_dir",
           "make_optimizer", "lr_boundaries"]
