from .base import topk_accuracy
from .local_cl_head import MSCLWithAugPosHeadV2
from .moco_head import MoCoHead
from .moco_head_v2 import MSCLWithAugMxHead

__all__ = ['topk_accuracy', 'MSCLWithAugPosHeadV2', 'MoCoHead',
           'MSCLWithAugMxHead']
