"""The host data path: the file, rawframe, pose, HVU, temporal
localization (ActivityNet features, SSN proposals), audio and AVA
datasets, their dataset wrappers, the numpy pipelines of the shipped
configs, batch blending and the loader of global batches (port of
``mscl_tpu/datasets``, the parts the ported configs name)."""
from . import pipelines  # noqa: F401  (registers the transforms)
from .activitynet_dataset import ActivityNetDataset
from .base import BaseDataset
from .blending import CutmixBlending, MixupBlending
from .builder import (BLENDINGS, DATASETS, PIPELINES, build_dataloader,
                      build_dataset)
from .dataset_wrappers import ConcatDataset, RepeatDataset
from .file_dataset import (DataTransfer, FileRawframe2BranchDataset,
                           FileRawframeDataset)
from .loader import NumpyLoader, default_collate
from .misc_datasets import HVUDataset, PoseDataset
from .rawframe_dataset import (AudioVisualDataset, ImageDataset,
                               RawframeDataset)
from .audio_dataset import AudioDataset, AudioFeatureDataset
from .ava_dataset import AVAAssignSample, AVADataset, SampleAVAFrames
from .ssn_dataset import SampleProposalFrames, SSNDataset, SSNInstance

__all__ = ['BaseDataset', 'DATASETS', 'PIPELINES', 'BLENDINGS',
           'build_dataset', 'build_dataloader', 'DataTransfer',
           'FileRawframeDataset', 'FileRawframe2BranchDataset',
           'RawframeDataset', 'ImageDataset', 'PoseDataset', 'RepeatDataset',
           'ConcatDataset', 'MixupBlending', 'CutmixBlending',
           'NumpyLoader', 'default_collate', 'ActivityNetDataset',
           'HVUDataset', 'SSNDataset', 'SSNInstance', 'SampleProposalFrames',
           'AudioDataset', 'AudioFeatureDataset', 'AudioVisualDataset',
           'AVADataset', 'AVAAssignSample', 'SampleAVAFrames']
