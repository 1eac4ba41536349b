from .steps import (EpisodeBatch, TrainState, create_train_state,
                    make_eval_step, make_train_step)
from .loop import run_eval, run_training, to_device, train_loop
from .checkpoint import CheckpointManager, verify_checkpoint_dir
from .schedule import make_optimizer, lr_boundaries
from .teacher_steps import (create_mfm_train_state, create_pretrain_state,
                            make_mfm, make_mfm_eval_step, make_mfm_train_step,
                            make_pretrain_model, make_pretrain_step, sum_ce)

__all__ = ["EpisodeBatch", "TrainState", "create_train_state",
           "make_eval_step", "make_train_step", "run_eval", "run_training",
           "to_device", "train_loop", "CheckpointManager",
           "verify_checkpoint_dir", "make_optimizer", "lr_boundaries",
           "create_mfm_train_state", "make_mfm", "make_mfm_eval_step",
           "make_mfm_train_step", "sum_ce", "create_pretrain_state",
           "make_pretrain_model", "make_pretrain_step"]
