"""BaseDataset: annotations plus the pipeline that turns one into a sample.

Port of ``mscl_tpu/datasets/base.py`` without ``evaluate`` (its accuracy
metrics come with the fine-tune slice). A plain indexable class, read by
``NumpyLoader``.
"""
from __future__ import annotations

import copy
import os.path as osp
from abc import ABCMeta, abstractmethod
from collections import defaultdict

import numpy as np

from .pipelines import Compose


class BaseDataset(metaclass=ABCMeta):

    def __init__(self, ann_file, pipeline, data_prefix=None, test_mode=False,
                 multi_class=False, num_classes=None, start_index=1,
                 modality='RGB', sample_by_class=False, power=0.0,
                 dynamic_length=False):
        super().__init__()
        self.ann_file = ann_file
        self.data_prefix = data_prefix
        if data_prefix is not None and osp.isdir(data_prefix):
            self.data_prefix = osp.realpath(data_prefix)
        self.test_mode = test_mode
        self.multi_class = multi_class
        self.num_classes = num_classes
        self.start_index = start_index
        self.modality = modality
        self.sample_by_class = sample_by_class
        self.power = power
        self.dynamic_length = dynamic_length

        self.pipeline = Compose(pipeline)
        self.video_infos = self.load_annotations()
        if self.sample_by_class:
            self.video_infos_by_class = self.parse_by_class()

    @abstractmethod
    def load_annotations(self):
        """Load the annotation according to ann_file into video_infos."""

    def parse_by_class(self):
        video_infos_by_class = defaultdict(list)
        for item in self.video_infos:
            label = item['label']
            video_infos_by_class[label].append(item)
        return video_infos_by_class

    @staticmethod
    def label2array(num, label):
        arr = np.zeros(num, dtype=np.float32)
        arr[label] = 1.
        return arr

    def prepare_train_frames(self, idx):
        results = copy.deepcopy(self.video_infos[idx])
        results['modality'] = self.modality
        results['start_index'] = self.start_index
        if self.multi_class:
            onehot = self.label2array(self.num_classes, results['label'])
            results['label'] = onehot
        return self.pipeline(results)

    def prepare_test_frames(self, idx):
        return self.prepare_train_frames(idx)

    def __len__(self):
        return len(self.video_infos)

    def __getitem__(self, idx):
        if self.test_mode:
            return self.prepare_test_frames(idx)
        return self.prepare_train_frames(idx)
