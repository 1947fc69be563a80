from .base import BaseHead, topk_accuracy
from .i3d_head import I3DHead
from .local_align_heads import (FGMoDistPredHead, MAMSCLWithAugPosHead,
                                MlvlMSCLWithAugPosHead, MoDistMSEPredHead,
                                MoDistPredDTHead, MoDistPredHead,
                                MoDistv2PosHead, MSCLWithAugAPPosHead,
                                MSCLWithAugPosHead, MSCLWithAugSimpleHead,
                                MTMoDistPredHead, frame_sim_scores)
from .local_cl_head import MSCLWithAugPosHeadV2
from .moco_head import MoCoHead
from .moco_head_v2 import MSCLWithAugMxHead

__all__ = ['BaseHead', 'I3DHead', 'topk_accuracy', 'MSCLWithAugPosHeadV2',
           'MoCoHead', 'MSCLWithAugMxHead', 'MoDistPredHead',
           'MoDistMSEPredHead', 'FGMoDistPredHead', 'MoDistPredDTHead',
           'MTMoDistPredHead', 'MoDistv2PosHead', 'MSCLWithAugPosHead',
           'MSCLWithAugSimpleHead', 'MSCLWithAugAPPosHead',
           'MlvlMSCLWithAugPosHead', 'MAMSCLWithAugPosHead',
           'frame_sim_scores']
