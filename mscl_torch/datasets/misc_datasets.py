"""PoseDataset: pickled skeleton annotations for PoseC3D.

Port of ``mscl_tpu/datasets/misc_datasets.py`` ``PoseDataset`` (reference
mmaction pose_dataset.py:12-99): a list of dicts (``frame_dir``,
``total_frames``, ``img_shape``, ``label``, ``keypoint`` (persons, frames,
K, 2), ``keypoint_score``), frames numbered from 0; ``valid_ratio`` keeps
the videos whose valid frames (at ``box_thr``) are at least that share,
and a ``box_thr`` above 0.5 lists the detections it keeps (``anno_inds``,
for ``LoadKineticsPose``). ``class_prob`` is recorded only, as in the JAX
package.
"""
from __future__ import annotations

import os.path as osp
import pickle

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
