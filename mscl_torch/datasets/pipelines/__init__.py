from .augmentations import (CenterCrop, ColorJitter, Flip, Fuse,
                            GPUNormalize, MultiGroupCrop, MultiScaleCrop,
                            Normalize, RandomCrop, RandomRescale,
                            RandomResizedCrop, RandomScale, Resize, TenCrop,
                            ThreeCrop, get_random_resized_crop_bbox,
                            rescale_size)
from .combined_augmentations import MoCoTransform
from .compose import Compose
from .formatting import (Collect, FormatShape, ImageToTensor, Rename,
                         ToDataContainer, ToTensor, Transpose,
                         batched_to_tensor, to_tensor)
from .loading import (ArrayDecode, BuildPseudoClip, DenseSampleFrames,
                      ImageDecode, LocalDecode, RawFrameDecode, SampleFrames,
                      UntrimmedSampleFrames)
from .mcl_augmentations import MCLRandomResizedCrop, motion_map_from_flow
from .loading_localization import (GenerateLocalizationLabels, LoadHVULabel,
                                   LoadLocalizationFeature, LoadProposals)
from .loading_mscl import (AlignIndex, ChosenSampleFrames, FlowToGT,
                           MatchFlow, Seg2T, TemporalShiftChosenSampleFrames,
                           TemporalShiftSampleFrames)
from .moco_augmentations import (MoCoDecodePlan, MoCoNormalize,
                                 MoCoNormalizeV2, MoCoRandomResizedCrop,
                                 MoCoResize)
from .pose_loading import (GeneratePoseTarget, LoadKineticsPose, PoseCompact,
                           PoseDecode, UniformSampleFrames)
from .transforms_motion import (Flow2ImgWithAug, NormFlowV2,
                                NormFlowWithAug, NormFlowWithAugV2,
                                NormFlowWithStidedAug,
                                NormFlowWithStidedAugV2, norm_flow,
                                rotate_flow)

__all__ = [
    'Compose', 'Collect', 'ToTensor', 'to_tensor', 'batched_to_tensor',
    'Rename', 'FormatShape', 'Transpose', 'ImageToTensor', 'ToDataContainer',
    'SampleFrames', 'DenseSampleFrames', 'UntrimmedSampleFrames',
    'ImageDecode', 'BuildPseudoClip',
    'RawFrameDecode', 'LocalDecode', 'ArrayDecode', 'MatchFlow',
    'ChosenSampleFrames', 'TemporalShiftChosenSampleFrames',
    'MoCoDecodePlan', 'MoCoRandomResizedCrop', 'MoCoResize', 'MoCoNormalize',
    'MoCoTransform',
    'NormFlowWithAug', 'NormFlowWithStidedAug', 'norm_flow', 'rotate_flow',
    'get_random_resized_crop_bbox', 'rescale_size', 'RandomCrop',
    'RandomResizedCrop', 'MultiScaleCrop', 'CenterCrop', 'ThreeCrop',
    'TenCrop', 'MultiGroupCrop', 'Resize', 'RandomRescale', 'RandomScale',
    'Normalize', 'ColorJitter', 'GPUNormalize', 'Flip', 'Fuse', 'Seg2T',
    'MCLRandomResizedCrop', 'motion_map_from_flow',
    'UniformSampleFrames', 'PoseDecode', 'GeneratePoseTarget',
    'LoadKineticsPose', 'PoseCompact', 'AlignIndex',
    'TemporalShiftSampleFrames', 'FlowToGT', 'Flow2ImgWithAug',
    'NormFlowWithStidedAugV2', 'NormFlowWithAugV2', 'NormFlowV2',
    'MoCoNormalizeV2', 'LoadLocalizationFeature', 'GenerateLocalizationLabels',
    'LoadProposals', 'LoadHVULabel',
]
