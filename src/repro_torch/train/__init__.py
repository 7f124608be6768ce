from .train_step import make_train_state, make_train_step
from .trainer import Trainer, TrainerConfig

__all__ = ["make_train_state", "make_train_step", "Trainer", "TrainerConfig"]
