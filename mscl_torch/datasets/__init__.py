"""The host data path of pretraining: the file dataset, the numpy
pipelines of the flagship config and the loader of global batches (port of
``mscl_tpu/datasets``, the parts that config names)."""
from . import pipelines  # noqa: F401  (registers the transforms)
from .base import BaseDataset
from .builder import DATASETS, PIPELINES, build_dataloader, build_dataset
from .file_dataset import (DataTransfer, FileRawframe2BranchDataset,
                           FileRawframeDataset)
from .loader import NumpyLoader, default_collate

__all__ = ['BaseDataset', 'DATASETS', 'PIPELINES', 'build_dataset',
           'build_dataloader', 'DataTransfer', 'FileRawframeDataset',
           'FileRawframe2BranchDataset', 'NumpyLoader', 'default_collate']
