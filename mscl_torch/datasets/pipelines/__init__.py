from .augmentations import (CenterCrop, Flip, Fuse, Normalize,
                            RandomResizedCrop, Resize,
                            get_random_resized_crop_bbox, rescale_size)
from .combined_augmentations import MoCoTransform
from .compose import Compose
from .formatting import Collect, ToTensor, batched_to_tensor, to_tensor
from .loading import ArrayDecode, LocalDecode, SampleFrames
from .mcl_augmentations import MCLRandomResizedCrop, motion_map_from_flow
from .loading_mscl import (ChosenSampleFrames, MatchFlow, Seg2T,
                           TemporalShiftChosenSampleFrames)
from .moco_augmentations import (MoCoDecodePlan, MoCoNormalize,
                                 MoCoRandomResizedCrop, MoCoResize)
from .transforms_motion import (NormFlowWithAug, NormFlowWithStidedAug,
                                norm_flow, rotate_flow)

__all__ = [
    'Compose', 'Collect', 'ToTensor', 'to_tensor', 'batched_to_tensor',
    'SampleFrames', 'LocalDecode', 'ArrayDecode', 'MatchFlow',
    'ChosenSampleFrames', 'TemporalShiftChosenSampleFrames',
    'MoCoDecodePlan', 'MoCoRandomResizedCrop', 'MoCoResize', 'MoCoNormalize',
    'MoCoTransform',
    'NormFlowWithAug', 'NormFlowWithStidedAug', 'norm_flow', 'rotate_flow',
    'get_random_resized_crop_bbox', 'rescale_size', 'RandomResizedCrop',
    'CenterCrop', 'Resize', 'Normalize', 'Flip', 'Fuse', 'Seg2T',
    'MCLRandomResizedCrop', 'motion_map_from_flow',
]
