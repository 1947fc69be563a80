"""ActivityNetDataset — temporal-proposal feature dataset for BMN/BSN.

Port of ``mscl_tpu/datasets/activitynet_dataset.py``, the same numpy: a
video's ``.npy`` features resized linearly to ``temporal_dim`` rows
(``raw_feature``), its segments over its duration (``gt_bbox``, ragged
over videos: BMN's and TEM's labels come from it by their models'
``generate_labels``), and AR@AN with its AUC.

Parity: reference mmaction/datasets/activitynet_dataset.py — json
annotations {video_name: {duration_second, duration_frame, annotations:
[{segment, label}], feature_frame}}, per-video feature csv/npy files,
AR@AN evaluation.
"""
from __future__ import annotations

import json
import os.path as osp

import numpy as np

from .base import BaseDataset
from .builder import DATASETS


@DATASETS.register_module()
class ActivityNetDataset(BaseDataset):

    def __init__(self, ann_file, pipeline, data_prefix=None,
                 test_mode=False, temporal_dim=100, **kwargs):
        self.temporal_dim = temporal_dim
        super().__init__(ann_file, pipeline, data_prefix, test_mode,
                         start_index=0, **kwargs)

    def load_annotations(self):
        with open(self.ann_file) as f:
            anno_database = json.load(f)
        video_infos = []
        for video_name, video_info in anno_database.items():
            info = dict(video_info)
            info['video_name'] = video_name
            video_infos.append(info)
        return video_infos

    def _import_ground_truth(self):
        ground_truth = {}
        for video_info in self.video_infos:
            video_id = video_info['video_name'][2:] \
                if video_info['video_name'].startswith('v_') else \
                video_info['video_name']
            this_gt = []
            for ann in video_info.get('annotations', []):
                t_start, t_end = ann['segment']
                this_gt.append([t_start, t_end])
            if this_gt:
                ground_truth[video_id] = np.array(this_gt)
        return ground_truth

    def _load_feature(self, video_info):
        path = osp.join(self.data_prefix or '',
                        video_info['video_name'] + '.npy')
        feat = np.load(path).astype(np.float32)
        # resize temporally to temporal_dim by linear interpolation
        t = feat.shape[0]
        if t != self.temporal_dim:
            idx = np.linspace(0, t - 1, self.temporal_dim)
            lo = np.floor(idx).astype(int)
            hi = np.minimum(lo + 1, t - 1)
            w = (idx - lo)[:, None]
            feat = feat[lo] * (1 - w) + feat[hi] * w
        return feat

    def prepare_train_frames(self, idx):
        video_info = self.video_infos[idx]
        results = dict(video_info)
        results['raw_feature'] = self._load_feature(video_info)
        # normalized gt segments for label generation
        duration = float(video_info.get('duration_second', 1.0))
        gt = [[a['segment'][0] / duration, a['segment'][1] / duration]
              for a in video_info.get('annotations', [])]
        results['gt_bbox'] = np.asarray(gt, np.float32) if gt else \
            np.zeros((0, 2), np.float32)
        if self.pipeline.transforms:
            return self.pipeline(results)
        return results

    prepare_test_frames = prepare_train_frames

    def evaluate(self, results, metrics='AR@AN', metric_options=None,
                 **kwargs):
        """results: list of dicts {video_name, proposal_list}
        (reference activitynet_dataset.py evaluate)."""
        from ..localization.proposal_utils import \
            average_recall_at_avg_proposals
        ground_truth = self._import_ground_truth()
        proposals = {}
        total = 0
        for r in results:
            vid = r['video_name']
            vid = vid[2:] if vid.startswith('v_') else vid
            arr = np.array([[p['segment'][0], p['segment'][1],
                             p['score']] for p in r['proposal_list']])
            proposals[vid] = arr
            total += len(arr)
        recall, avg_recall, prop_per_video, auc = \
            average_recall_at_avg_proposals(ground_truth, proposals,
                                            total)
        out = {'auc': auc}
        for an in (1, 5, 10, 100):
            i = min(an, len(avg_recall)) - 1
            out[f'AR@{an}'] = float(avg_recall[i])
        return out
