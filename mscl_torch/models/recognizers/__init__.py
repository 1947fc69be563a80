from .base import (get_ssl_state_dict, graft, init_from_ssl_pretrain,
                   parse_losses)
from .moco import MLP, MoCo, MoCoBase, MoCoV2, build_ema_fn
from .mscl import MSCLWithAug
from .recognizer3d import Recognizer3D

__all__ = ['parse_losses', 'get_ssl_state_dict', 'graft',
           'init_from_ssl_pretrain', 'MLP', 'MoCo', 'MoCoBase', 'MoCoV2',
           'build_ema_fn',
           'MSCLWithAug', 'Recognizer3D']
