from .base import parse_losses
from .moco import MLP, MoCoV2, build_ema_fn
from .mscl import MSCLWithAug

__all__ = ['parse_losses', 'MLP', 'MoCoV2', 'build_ema_fn', 'MSCLWithAug']
