from .checkpoint import (latest_checkpoint, load_checkpoint, load_meta,
                         publish_model, restore_model_state,
                         restore_train_state, save_checkpoint, train_state)
from .lr_schedule import build_lr_schedule
from .optimizer import SGD, build_optimizer
from .train_loop import OmniSourceRunner, Runner, make_train_step, to_torch

__all__ = ['build_lr_schedule', 'SGD', 'build_optimizer', 'make_train_step',
           'Runner', 'OmniSourceRunner', 'to_torch', 'save_checkpoint',
           'load_checkpoint', 'load_meta', 'latest_checkpoint',
           'publish_model', 'restore_model_state', 'restore_train_state',
           'train_state']
