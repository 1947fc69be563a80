"""PoseDataset: pickled skeleton annotations for PoseC3D; HVUDataset: the
multi-category tags of HVU.

Port of ``mscl_tpu/datasets/misc_datasets.py`` ``PoseDataset`` (reference
mmaction pose_dataset.py:12-99): a list of dicts (``frame_dir``,
``total_frames``, ``img_shape``, ``label``, ``keypoint`` (persons, frames,
K, 2), ``keypoint_score``), frames numbered from 0; ``valid_ratio`` keeps
the videos whose valid frames (at ``box_thr``) are at least that share,
and a ``box_thr`` above 0.5 lists the detections it keeps (``anno_inds``,
for ``LoadKineticsPose``). ``class_prob`` is recorded only, as in the JAX
package.

``HVUDataset`` is the port of the JAX one (reference hvu_dataset.py:1-192):
a json list of videos with their tags by category, each item's tags
assembled into one flat one-hot target over all categories before its
pipeline runs, and the mAP of each category. ``LoadHVULabel`` takes the
tag dict itself, so the shipped HVU config, which chains the two, fails by
name at that step, where the JAX one fails; so does an item over frame
directories without ``filename_tmpl``, which the config leaves None.
"""
from __future__ import annotations

import copy
import json
import os.path as osp
import pickle
from collections import OrderedDict

import numpy as np

from .base import BaseDataset
from .builder import DATASETS


@DATASETS.register_module()
class PoseDataset(BaseDataset):

    def __init__(self, ann_file, pipeline, valid_ratio=None,
                 box_thr=None, class_prob=None, **kwargs):
        super().__init__(ann_file, pipeline, start_index=0,
                         modality='Pose', **kwargs)
        self.box_thr = box_thr
        if box_thr is not None:
            assert box_thr in ('0.5', '0.6', '0.7', '0.8', '0.9')
        self.valid_ratio = valid_ratio
        if valid_ratio is not None:
            assert isinstance(valid_ratio, float)
            key = 'valid_frames' if box_thr is None else \
                f'valid@{box_thr}'
            self.video_infos = [
                x for x in self.video_infos
                if x[key] / x['total_frames'] >= valid_ratio]
            if box_thr is not None and box_thr != '0.5':
                thr = float(box_thr)
                for item in self.video_infos:
                    item['anno_inds'] = np.array(
                        [i for i, s in enumerate(item['box_score'])
                         if s >= thr])
        if class_prob is not None:
            self.class_prob = class_prob

    def load_annotations(self):
        assert self.ann_file.endswith('.pkl')
        with open(self.ann_file, 'rb') as f:
            data = pickle.load(f)
        for item in data:
            for key in ('filename', 'frame_dir'):
                if key in item and self.data_prefix is not None:
                    item[key] = osp.join(self.data_prefix, item[key])
        return data


@DATASETS.register_module()
class HVUDataset(BaseDataset):

    def __init__(self, ann_file, pipeline, tag_categories,
                 tag_category_nums, filename_tmpl=None, **kwargs):
        assert len(tag_categories) == len(tag_category_nums)
        self.tag_categories = list(tag_categories)
        self.tag_category_nums = list(tag_category_nums)
        self.filename_tmpl = filename_tmpl
        self.num_categories = len(tag_categories)
        self.num_tags = sum(tag_category_nums)
        self.category2num = dict(zip(tag_categories, tag_category_nums))
        self.start_idx = [0]
        for i in range(self.num_categories - 1):
            self.start_idx.append(self.start_idx[-1] +
                                  self.tag_category_nums[i])
        self.category2startidx = dict(zip(tag_categories,
                                          self.start_idx))
        start_index = kwargs.pop('start_index', 0)
        super().__init__(ann_file, pipeline, start_index=start_index,
                         **kwargs)

    def load_annotations(self):
        assert self.ann_file.endswith('.json')
        with open(self.ann_file) as f:
            video_infos = json.load(f)
        info0 = video_infos[0]
        assert ('filename' in info0) != ('frame_dir' in info0)
        path_key = 'filename' if 'filename' in info0 else 'frame_dir'
        for info in video_infos:
            if self.data_prefix is not None:
                info[path_key] = osp.join(self.data_prefix,
                                          info[path_key])
            info['categories'] = self.tag_categories
            info['category_nums'] = self.tag_category_nums
            if path_key == 'frame_dir':
                info['filename_tmpl'] = self.filename_tmpl
                info['start_index'] = self.start_index
                info['modality'] = self.modality
        return video_infos

    def _prepare(self, idx):
        results = copy.deepcopy(self.video_infos[idx])
        # assemble the flat multi-category one-hot target
        onehot = np.zeros(self.num_tags, np.float32)
        for cat, tags in results['label'].items():
            onehot[np.array(tags) + self.category2startidx[cat]] = 1.0
        results['label'] = onehot
        if 'filename_tmpl' not in results and \
                self.filename_tmpl is not None:
            results['filename_tmpl'] = self.filename_tmpl
        results.setdefault('modality', self.modality)
        results.setdefault('start_index', self.start_index)
        return self.pipeline(results)

    prepare_train_frames = _prepare
    prepare_test_frames = _prepare

    @staticmethod
    def label2array(num, label):
        arr = np.zeros(num, np.float32)
        arr[label] = 1.0
        return arr

    def evaluate(self, results, metrics='mean_average_precision',
                 metric_options=None, **kwargs):
        from ..core.evaluation.accuracy import mean_average_precision
        metrics = metrics if isinstance(metrics, (list, tuple)) else \
            [metrics]
        assert metrics == ['mean_average_precision']
        gt_labels = [ann['label'] for ann in self.video_infos]
        out = OrderedDict()
        for category in self.tag_categories:
            start = self.category2startidx[category]
            num = self.category2num[category]
            preds = [r[start:start + num]
                     for i, r in enumerate(results)
                     if category in gt_labels[i]]
            gts = [self.label2array(num, g[category])
                   for g in gt_labels if category in g]
            out[f'{category}_mAP'] = mean_average_precision(preds, gts)
        return out
