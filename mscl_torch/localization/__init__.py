"""Temporal localization on the host: proposal IoU, soft-NMS and
post-processing, BSN's proposal generation, SSN's proposal files and
AP, ActivityNet detection mAP (the port's copy of
``mscl_tpu/localization``, pure numpy)."""
from .bsn_utils import generate_bsp_feature, generate_candidate_proposals
from .det_eval import (ActivityNetDetection,
                       ActivityNetLocalization, box_iou, frame_map)
from .ssn_utils import (average_precision_at_temporal_iou, eval_ap,
                        load_localize_proposal_file, perform_regression,
                        temporal_nms)
from .proposal_utils import (average_recall_at_avg_proposals,
                             post_processing, soft_nms, temporal_iop,
                             temporal_iou)

__all__ = ['temporal_iou', 'temporal_iop', 'soft_nms', 'post_processing',
           'average_recall_at_avg_proposals', 'box_iou', 'frame_map',
           'ActivityNetDetection', 'ActivityNetLocalization',
           'load_localize_proposal_file', 'perform_regression',
           'temporal_nms', 'eval_ap',
           'average_precision_at_temporal_iou',
           'generate_candidate_proposals', 'generate_bsp_feature']
