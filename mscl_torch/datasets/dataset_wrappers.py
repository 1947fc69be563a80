"""RepeatDataset and ConcatDataset (port of
``mscl_tpu/datasets/dataset_wrappers.py``, reference mmaction
dataset_wrappers.py); ``build_dataset`` builds them from their configs."""
from __future__ import annotations

import numpy as np

from .builder import DATASETS


@DATASETS.register_module()
class RepeatDataset:
    """``dataset`` listed ``times`` over."""

    def __init__(self, dataset, times):
        self.dataset = dataset
        self.times = times
        self._ori_len = len(self.dataset)

    def __getitem__(self, idx):
        return self.dataset[idx % self._ori_len]

    def __len__(self):
        return self.times * self._ori_len


@DATASETS.register_module()
class ConcatDataset:
    """``datasets`` one after the other."""

    def __init__(self, datasets):
        self.datasets = datasets
        self.cumulative_sizes = np.cumsum([len(d) for d in datasets])

    def __len__(self):
        return int(self.cumulative_sizes[-1])

    def __getitem__(self, idx):
        if idx < 0:
            idx = len(self) + idx
        dataset_idx = int(np.searchsorted(self.cumulative_sizes, idx,
                                          side='right'))
        sample_idx = idx if dataset_idx == 0 else \
            idx - int(self.cumulative_sizes[dataset_idx - 1])
        return self.datasets[dataset_idx][sample_idx]
