"""AVADataset: spatio-temporal action detection annotations, and the
pipeline steps of its configs.

Port of ``mscl_tpu/datasets/ava_dataset.py`` (reference mmaction
ava_dataset.py), numpy, bit for bit:

- ``AVADataset``: the csv's rows (video_id, timestamp, x1, y1, x2, y2
  normalized, action, person) grouped by keyframe, each box a multilabel
  row over ``num_classes``; the exclude file's keyframes left out; each
  keyframe's person-detector proposals kept where their score reaches
  ``min(person_det_score_thr, the best score)``, at most
  ``num_max_proposals``. ``evaluate`` is frame mAP at IoU 0.5
  (``localization.det_eval.frame_map``). ``RedisAVADataset`` (the name the
  reference's redis-served configs give) is the same class.
- ``SampleAVAFrames``: ``clip_len`` frames ``frame_interval`` apart
  around the keyframe (frame fps * (timestamp - timestamp_start) + 1),
  each jittered in training by a draw from the global ``np.random``, and
  clipped to the shot.
- ``AVAAssignSample``: ``core.bbox.assign_and_sample`` over the clip's
  proposals: ``rois`` (num, 4), ``roi_labels`` (num, C), ``roi_weights``
  (num,), the padding's weight 0. With a ``seed`` every call draws from
  ``np.random.default_rng(seed)``, as JAX's does (so every sample draws
  the same numbers); without one, from a generator seeded from the global
  ``np.random`` stream (JAX's takes an OS-seeded one, which no run can
  repeat).

Matched on purpose, a fault of the reference: with ``custom_classes`` the
rows are filtered by the raw action ids, but each id is one-hot encoded
as it is and dropped if it is not below ``num_classes``
(``mscl_tpu/datasets/ava_dataset.py:136-148``); mmaction2 remaps the
custom classes to 1..n. So ``slowonly_..._custom_classes`` (classes
11-80, ``num_classes=10``) gives every box an all-zero row.

The annotations, the exclude file and the proposal pickle are all read
by ``load_annotations``.
"""
from __future__ import annotations

import copy
import csv
import os.path as osp
import pickle
from collections import defaultdict

import numpy as np

from ..core.bbox import assign_and_sample, host_rng
from .base import BaseDataset
from .builder import DATASETS, PIPELINES
from .pipelines.loading import SampleFrames


@PIPELINES.register_module()
class SampleAVAFrames(SampleFrames):

    def __init__(self, clip_len, frame_interval=2, test_mode=False):
        super().__init__(clip_len, frame_interval, test_mode=test_mode)

    def __call__(self, results):
        fps = results['fps']
        shot_info = results['shot_info']
        center_index = fps * (results['timestamp'] -
                              results['timestamp_start']) + 1
        start = center_index - (self.clip_len // 2) * self.frame_interval
        end = center_index + ((self.clip_len + 1) // 2) * \
            self.frame_interval
        frame_inds = np.arange(start, end, self.frame_interval)
        if not self.test_mode:
            skip = np.random.randint(-(self.frame_interval // 2),
                                     (self.frame_interval + 1) // 2,
                                     size=self.clip_len)
            frame_inds = frame_inds + skip
        frame_inds = np.clip(frame_inds, shot_info[0], shot_info[1] - 1)
        results['frame_inds'] = frame_inds.astype(np.int64)
        results['clip_len'] = self.clip_len
        results['frame_interval'] = self.frame_interval
        results['num_clips'] = 1
        results['crop_quadruple'] = np.array([0, 0, 1, 1], dtype=np.float32)
        return results


@PIPELINES.register_module()
class AVAAssignSample:

    def __init__(self, rcnn, seed=None):
        self.rcnn = rcnn
        self.seed = seed

    def __call__(self, results):
        gt_bboxes = np.asarray(results['gt_bboxes'], np.float32)
        gt_labels = np.asarray(results['gt_labels'], np.float32)
        proposals = np.asarray(
            results.get('proposals', np.zeros((0, 4), np.float32)),
            np.float32)
        rng = np.random.default_rng(self.seed) if self.seed is not None \
            else host_rng()
        results.update(assign_and_sample(proposals, gt_bboxes, gt_labels,
                                         self.rcnn, rng))
        return results


@DATASETS.register_module()
class AVADataset(BaseDataset):

    def __init__(self, ann_file, pipeline, exclude_file=None,
                 label_file=None, data_prefix=None, test_mode=False,
                 proposal_file=None, person_det_score_thr=0.9,
                 num_classes=81, filename_tmpl='img_{:05}.jpg',
                 num_max_proposals=1000, timestamp_start=900,
                 timestamp_end=1800, fps=30, custom_classes=None,
                 **kwargs):
        self.exclude_file = exclude_file
        self.label_file = label_file
        self.proposal_file = proposal_file
        self.person_det_score_thr = person_det_score_thr
        self._num_classes = num_classes
        self.filename_tmpl = filename_tmpl
        self.num_max_proposals = num_max_proposals
        self.timestamp_start = timestamp_start
        self.timestamp_end = timestamp_end
        self.fps = fps
        self.custom_classes = custom_classes
        self.proposals = None
        super().__init__(ann_file, pipeline, data_prefix, test_mode,
                         num_classes=num_classes, start_index=1,
                         modality='RGB')

    def _records(self):
        records = defaultdict(lambda: defaultdict(set))
        with open(self.ann_file) as f:
            for row in csv.reader(f):
                if not row:
                    continue
                label = int(row[6])
                if self.custom_classes is not None and \
                        label not in self.custom_classes:
                    continue
                box = tuple(float(x) for x in row[2:6])
                records[(row[0], int(float(row[1])))][box].add(label)
        return records

    def load_annotations(self):
        video_infos = []
        for (vid, ts), boxes in sorted(self._records().items()):
            gt_bboxes, gt_labels = [], []
            for box, labels in boxes.items():
                gt_bboxes.append(box)
                onehot = np.zeros(self._num_classes, np.float32)
                for lb in labels:
                    if 0 <= lb < self._num_classes:
                        onehot[lb] = 1.0
                gt_labels.append(onehot)
            frame_dir = vid if self.data_prefix is None else \
                osp.join(self.data_prefix, vid)
            video_infos.append(dict(
                video_id=vid, timestamp=ts, frame_dir=frame_dir,
                fps=self.fps, timestamp_start=self.timestamp_start,
                timestamp_end=self.timestamp_end,
                shot_info=(0, (self.timestamp_end - self.timestamp_start)
                           * self.fps),
                gt_bboxes=np.array(gt_bboxes, np.float32),
                gt_labels=np.stack(gt_labels), label=0))
        if self.proposal_file is not None:
            with open(self.proposal_file, 'rb') as f:
                self.proposals = pickle.load(f)
        if self.exclude_file is not None:
            excluded = set()
            with open(self.exclude_file) as f:
                for line in f:
                    vid, ts = line.strip().split(',')[:2]
                    excluded.add((vid, int(float(ts))))
            video_infos = [v for v in video_infos
                           if (v['video_id'], v['timestamp']) not in excluded]
        return video_infos

    def img_key(self, idx):
        info = self.video_infos[idx]
        return f"{info['video_id']},{info['timestamp']:04d}"

    def _prepare(self, idx):
        results = copy.deepcopy(self.video_infos[idx])
        results['filename_tmpl'] = self.filename_tmpl
        results['modality'] = self.modality
        results['start_index'] = self.start_index
        key = self.img_key(idx)
        if self.proposals is not None and key in self.proposals:
            props = np.asarray(self.proposals[key], np.float32)
            if props.shape[-1] == 5:
                keep = props[:, 4] >= min(self.person_det_score_thr,
                                          props[:, 4].max())
                props = props[keep][:, :4]
            results['proposals'] = props[:self.num_max_proposals]
        return self.pipeline(results)

    prepare_train_frames = _prepare
    prepare_test_frames = _prepare

    def evaluate(self, results, metrics=('mAP',), **kwargs):
        """``results``: a dict a keyframe, in the dataset's order, with
        'bboxes' (N, 4) normalized and 'scores' (N, C) -> {'mAP@0.5IOU'}."""
        from ..localization.det_eval import frame_map
        gts, dets = [], []
        for info, res in zip(self.video_infos, results):
            gts.append(dict(bboxes=info['gt_bboxes'],
                            labels=info['gt_labels']))
            dets.append(res)
        return {'mAP@0.5IOU': frame_map(dets, gts,
                                        num_classes=self._num_classes)}


DATASETS.register_module(name='RedisAVADataset', module=AVADataset)
