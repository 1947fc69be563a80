from .base import BaseHead, topk_accuracy
from .i3d_head import I3DHead
from .lfb import (LFB, ACRNHead, FBOHead, FBONonLocal, LFBInferHead,
                  NonLocalLayer, sample_lfb)
from .local_align_heads import (FGMoDistPredHead, MAMSCLWithAugPosHead,
                                MlvlMSCLWithAugPosHead, MoDistMSEPredHead,
                                MoDistPredDTHead, MoDistPredHead,
                                MoDistv2PosHead, MSCLWithAugAPPosHead,
                                MSCLWithAugPosHead, MSCLWithAugSimpleHead,
                                MTMoDistPredHead, frame_sim_scores)
from .local_cl_head import MSCLWithAugPosHeadV2
from .moco_head import MoCoHead
from .moco_head_v2 import MSCLWithAugMxHead
from .recognition_heads import (AudioTSNHead, SlowFastHead, TimeSformerHead,
                                TPNHead, TRNHead, TSMHead, TSNHead, X3DHead)
from .moco_head_v3 import (MoCoHeadV2, MSCLWithAugDistillMxHead,
                           MSCLWithAugMSFMxHead, MSFHead, NMSFHead)
from .reid_distill_heads import (FGTSMReidSimpleHead, RcMoDistHead,
                                 TSMHead3D, TSMReidSimpleHead)

__all__ = ['LFB', 'ACRNHead', 'FBOHead', 'FBONonLocal', 'LFBInferHead',
           'NonLocalLayer', 'sample_lfb', 'BaseHead', 'I3DHead', 'topk_accuracy', 'MSCLWithAugPosHeadV2',
           'MoCoHead', 'MSCLWithAugMxHead', 'MoDistPredHead',
           'MoDistMSEPredHead', 'FGMoDistPredHead', 'MoDistPredDTHead',
           'MTMoDistPredHead', 'MoDistv2PosHead', 'MSCLWithAugPosHead',
           'MSCLWithAugSimpleHead', 'MSCLWithAugAPPosHead',
           'MlvlMSCLWithAugPosHead', 'MAMSCLWithAugPosHead',
           'frame_sim_scores', 'MoCoHeadV2', 'MSFHead', 'NMSFHead',
           'MSCLWithAugMSFMxHead', 'MSCLWithAugDistillMxHead',
           'TSMReidSimpleHead', 'FGTSMReidSimpleHead', 'TSMHead3D',
           'RcMoDistHead', 'TSNHead', 'TSMHead', 'TPNHead', 'AudioTSNHead',
           'TimeSformerHead', 'X3DHead', 'SlowFastHead', 'TRNHead']
