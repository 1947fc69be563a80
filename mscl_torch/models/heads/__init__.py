from .base import BaseHead, topk_accuracy
from .i3d_head import I3DHead
from .local_cl_head import MSCLWithAugPosHeadV2
from .moco_head import MoCoHead
from .moco_head_v2 import MSCLWithAugMxHead

__all__ = ['BaseHead', 'I3DHead', 'topk_accuracy', 'MSCLWithAugPosHeadV2',
           'MoCoHead', 'MSCLWithAugMxHead']
