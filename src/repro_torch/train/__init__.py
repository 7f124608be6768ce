from .train_step import abstract_train_state, make_train_state, \
    make_train_step, train_state
from .trainer import Trainer, TrainerConfig

__all__ = ["abstract_train_state", "make_train_state", "make_train_step",
           "train_state", "Trainer", "TrainerConfig"]
