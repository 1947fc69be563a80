from .audio_recognizer import AudioRecognizer
from .base import (get_ssl_state_dict, graft, init_from_ssl_pretrain,
                   parse_losses)
from .moco import MLP, MoCo, MoCoBase, MoCoV2, build_ema_fn
from .mscl import MSCL, MoDist, MSCLWithAug
from .recognizer2d import Recognizer2D
from .recognizer3d import Recognizer3D

__all__ = ['AudioRecognizer', 'parse_losses', 'get_ssl_state_dict', 'graft',
           'init_from_ssl_pretrain', 'MLP', 'MoCo', 'MoCoBase', 'MoCoV2',
           'build_ema_fn',
           'MSCL', 'MoDist', 'MSCLWithAug', 'Recognizer2D', 'Recognizer3D']
