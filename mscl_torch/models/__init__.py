from .builder import (BACKBONES, HEADS, LOSSES, MODELS, NECKS, RECOGNIZERS,
                      build_backbone, build_head, build_loss, build_neck)
from . import backbones  # noqa: F401
from . import necks  # noqa: F401
from . import heads  # noqa: F401
from . import losses  # noqa: F401
from . import recognizers  # noqa: F401

__all__ = ['MODELS', 'BACKBONES', 'NECKS', 'HEADS', 'RECOGNIZERS', 'LOSSES',
           'build_backbone', 'build_neck', 'build_head', 'build_loss']
