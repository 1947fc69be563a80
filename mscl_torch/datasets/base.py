"""BaseDataset: annotations, the pipeline that turns one into a sample,
and ``evaluate`` (scores -> metrics).

Port of ``mscl_tpu/datasets/base.py`` (reference mmaction
datasets/base.py:19-290). A plain indexable class, read by ``NumpyLoader``.
"""
from __future__ import annotations

import copy
import os.path as osp
from abc import ABCMeta, abstractmethod
from collections import defaultdict

import numpy as np

from ..core.evaluation.accuracy import (mean_average_precision,
                                        mean_class_accuracy,
                                        mmit_mean_average_precision,
                                        top_k_accuracy)
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

    def evaluate(self, results, metrics='top_k_accuracy',
                 metric_options=dict(top_k_accuracy=dict(topk=(1, 5))),
                 logger=None, **deprecated_kwargs):
        """Evaluate prediction scores against dataset labels
        (reference base.py:150-260 semantics)."""
        if deprecated_kwargs:
            metric_options['top_k_accuracy'] = dict(deprecated_kwargs)
        if not isinstance(results, list):
            raise TypeError(f'results must be a list, got {type(results)}')
        assert len(results) == len(self), (
            f'The length of results is not equal to the dataset len: '
            f'{len(results)} != {len(self)}')

        metrics = [metrics] if isinstance(metrics, str) else metrics
        allowed = ['top_k_accuracy', 'mean_class_accuracy',
                   'vis_mean_class_accuracy', 'mean_average_precision',
                   'mmit_mean_average_precision']
        for metric in metrics:
            if metric not in allowed:
                raise KeyError(f'metric {metric} is not supported')

        eval_results = {}
        gt_labels = [ann['label'] for ann in self.video_infos]

        for metric in metrics:
            if metric == 'top_k_accuracy':
                topk = metric_options.setdefault(
                    'top_k_accuracy', {}).setdefault('topk', (1, 5))
                if isinstance(topk, int):
                    topk = (topk,)
                top_k_acc = top_k_accuracy(results, gt_labels, topk)
                for k, acc in zip(topk, top_k_acc):
                    eval_results[f'top{k}_acc'] = acc
            elif metric in ('mean_class_accuracy',
                            'vis_mean_class_accuracy'):
                mean_acc = mean_class_accuracy(results, gt_labels)
                eval_results['mean_class_accuracy'] = mean_acc
                if metric == 'vis_mean_class_accuracy' and \
                        getattr(self, 'visual_cfg', None):
                    from ..core.evaluation.visualizer import ClfVisualizer
                    ClfVisualizer(**self.visual_cfg).visualize(
                        results, gt_labels)
            elif metric == 'mean_average_precision':
                gt = [self.label2array(self.num_classes, label)
                      for label in gt_labels]
                eval_results['mean_average_precision'] = \
                    mean_average_precision(results, gt)
            elif metric == 'mmit_mean_average_precision':
                gt = [np.asarray(label) for label in gt_labels]
                eval_results['mmit_mean_average_precision'] = \
                    mmit_mean_average_precision(results, gt)
        return eval_results
