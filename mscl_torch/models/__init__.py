from .builder import (BACKBONES, HEADS, LOSSES, MODELS, NECKS, RECOGNIZERS,
                      SSL_AUGS, build_backbone, build_head, build_loss,
                      build_neck, build_ssl_aug)
from . import backbones  # noqa: F401
from . import common  # noqa: F401
from . import necks  # noqa: F401
from . import heads  # noqa: F401
from . import losses  # noqa: F401
from . import recognizers  # noqa: F401
from . import localizers  # noqa: F401
from . import detection  # noqa: F401

__all__ = ['MODELS', 'BACKBONES', 'NECKS', 'HEADS', 'RECOGNIZERS', 'LOSSES',
           'SSL_AUGS', 'build_backbone', 'build_neck', 'build_head',
           'build_loss', 'build_ssl_aug']
