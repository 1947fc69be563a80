from .lr_schedule import build_lr_schedule
from .optimizer import SGD, build_optimizer
from .train_loop import make_train_step

__all__ = ['build_lr_schedule', 'SGD', 'build_optimizer', 'make_train_step']
