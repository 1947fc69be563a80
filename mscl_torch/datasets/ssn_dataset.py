"""SSNDataset — proposal-based temporal action detection data path.

Port of ``mscl_tpu/datasets/ssn_dataset.py``, the same numpy: it draws
from the global ``np.random`` in the JAX one's order (the pools' choices,
``SampleProposalFrames``' offsets), so under one seed its items are the
JAX package's, bit for bit.

Parity: reference mmaction/datasets/ssn_dataset.py:1-882 —
  - SSNInstance proposal records with (loc, size) regression targets
    against the best-IoU gt (ssn_dataset.py:19-80)
  - positive / incomplete / background pools per assigner thresholds
    (ssn_dataset.py:491-597): positive = best_iou > pos_thr (+gts),
    incomplete = best_iou < inc_thr and overlap_self > 0.7,
    background = best_iou < bg_thr and coverage > 0.01
  - video-centric sampling with dataset-pool fallback and
    with-replacement refill (ssn_dataset.py:598-690)
  - stage scale factors for the STPP augmented stages
    (ssn_dataset.py:692-736)
  - regression-target normalization constants (ssn_dataset.py:738-750)
  - test-time relative proposals / ticks / scale factors
    (ssn_dataset.py:822-882)
  - detections + regression decode + temporal NMS + mAP@tIoU evaluate
    (ssn_dataset.py:331-489)

plus the SampleProposalFrames pipeline transform (reference
datasets/pipelines/loading.py:469-700): 3-stage (starting/course/ending)
segment sampling around each proposal.
"""
from __future__ import annotations

import copy
import os.path as osp
from typing import Dict, List, Optional, Tuple

import numpy as np

from .base import BaseDataset
from .builder import DATASETS, PIPELINES
from ..localization.proposal_utils import temporal_iou
from ..localization.ssn_utils import (eval_ap, load_localize_proposal_file,
                                      perform_regression, temporal_nms)


class SSNInstance:
    """One temporal proposal (reference ssn_dataset.py:19-80)."""

    def __init__(self, start_frame: int, end_frame: int,
                 num_video_frames: int, label: Optional[int] = None,
                 best_iou: float = 0.0, overlap_self: float = 0.0):
        self.start_frame = start_frame
        self.end_frame = min(end_frame, num_video_frames)
        self.num_video_frames = num_video_frames
        self.label = label if label is not None else -1
        self.coverage = (end_frame - start_frame) / num_video_frames
        self.best_iou = best_iou
        self.overlap_self = overlap_self
        self.regression_targets = (0.0, 0.0)

    def compute_regression_targets(self, gt_list: List['SSNInstance']):
        if not gt_list:
            return
        ious = [float(temporal_iou(self.start_frame, self.end_frame,
                                   gt.start_frame, gt.end_frame))
                for gt in gt_list]
        best = gt_list[int(np.argmax(ious))]
        p_center = (self.start_frame + self.end_frame - 1) / 2
        g_center = (best.start_frame + best.end_frame - 1) / 2
        p_size = self.end_frame - self.start_frame
        g_size = best.end_frame - best.start_frame
        self.regression_targets = ((g_center - p_center) / p_size,
                                   float(np.log(g_size / p_size)))


@PIPELINES.register_module()
class SampleProposalFrames:
    """Sample STPP-stage frame indices for each proposal of a video
    (reference loading.py:469-700)."""

    def __init__(self, clip_len, body_segments, aug_segments, aug_ratio,
                 frame_interval=1, test_interval=6, temporal_jitter=False,
                 mode='train'):
        self.clip_len = clip_len
        self.body_segments = body_segments
        self.aug_segments = aug_segments
        self.aug_ratio = (aug_ratio, aug_ratio) if isinstance(
            aug_ratio, (int, float)) else tuple(aug_ratio)
        self.frame_interval = frame_interval
        self.test_interval = test_interval
        self.temporal_jitter = temporal_jitter
        assert mode in ('train', 'val', 'test')
        self.mode = mode

    def _stage_offsets(self, valid_length, num_segments):
        if self.mode == 'train':
            avg = (valid_length + 1) // num_segments
            if avg > 0:
                return (np.arange(num_segments) * avg +
                        np.random.randint(avg, size=num_segments))
            return np.zeros((num_segments,), np.int64)
        if valid_length >= num_segments:
            avg = valid_length / float(num_segments)
            return (np.arange(num_segments) * avg + avg / 2.0).astype(
                np.int64)
        return np.zeros((num_segments,), np.int64)

    def _proposal_offsets(self, proposal: SSNInstance, num_frames: int):
        start, end = proposal.start_frame, proposal.end_frame
        ori_clip_len = self.clip_len * self.frame_interval
        duration = end - start
        valid_length = duration - ori_clip_len
        valid_starting = max(0, start - int(duration * self.aug_ratio[0]))
        valid_ending = min(num_frames - ori_clip_len + 1,
                           end - 1 + int(duration * self.aug_ratio[1]))
        valid_starting_length = start - valid_starting - ori_clip_len
        valid_ending_length = (valid_ending - end + 1) - ori_clip_len
        starting = self._stage_offsets(valid_starting_length,
                                       self.aug_segments[0]) + \
            valid_starting
        course = self._stage_offsets(valid_length,
                                     self.body_segments) + start
        ending = self._stage_offsets(valid_ending_length,
                                     self.aug_segments[1]) + end
        return np.concatenate([starting, course, ending])

    def __call__(self, results):
        num_frames = results['total_frames']
        ori_clip_len = self.clip_len * self.frame_interval
        if self.mode == 'test':
            offsets = np.arange(0, num_frames - ori_clip_len,
                                self.test_interval, dtype=np.int64)
        else:
            offsets = np.concatenate([
                self._proposal_offsets(p[0][1], num_frames)
                for p in results['out_proposals']])
        frame_inds = (offsets[:, None] +
                      np.arange(self.clip_len)[None, :] *
                      self.frame_interval).reshape(-1)
        if self.temporal_jitter:
            frame_inds = frame_inds + np.random.randint(
                self.frame_interval, size=len(frame_inds))
        frame_inds = np.mod(frame_inds, num_frames) + \
            results['start_index']
        results['frame_inds'] = frame_inds.astype(np.int64)
        results['clip_len'] = self.clip_len
        results['frame_interval'] = self.frame_interval
        # segments per proposal (reference loading.py:703-704); in test
        # mode num_clips is the tick count for feature extraction
        if self.mode == 'test':
            results['num_clips'] = len(offsets)
        else:
            results['num_clips'] = (self.body_segments +
                                    self.aug_segments[0] +
                                    self.aug_segments[1])
            results['num_proposals'] = len(results['out_proposals'])
        return results


@DATASETS.register_module()
class SSNDataset(BaseDataset):

    def __init__(self, ann_file, pipeline, train_cfg, test_cfg,
                 data_prefix=None, test_mode=False,
                 filename_tmpl='img_{:05d}.jpg', start_index=1,
                 modality='RGB', video_centric=True,
                 reg_normalize_constants=None, body_segments=5,
                 aug_segments=(2, 2), aug_ratio=(0.5, 0.5), clip_len=1,
                 frame_interval=1, filter_gt=True, use_regression=True,
                 **kwargs):
        self.filename_tmpl = filename_tmpl
        super().__init__(ann_file, pipeline, data_prefix, test_mode,
                         start_index=start_index, modality=modality)
        self.train_cfg = train_cfg
        self.test_cfg = test_cfg
        ssn_train = train_cfg['ssn'] if isinstance(train_cfg, dict) else \
            train_cfg.ssn
        self.assigner = dict(ssn_train['assigner'])
        self.sampler = dict(ssn_train['sampler'])
        ssn_test = test_cfg['ssn'] if isinstance(test_cfg, dict) else \
            test_cfg.ssn
        self.evaluater = dict(ssn_test.get('evaluater', {}))
        self.test_interval = dict(ssn_test.get('sampler', {})).get(
            'test_interval', 6)

        if filter_gt or not test_mode:
            self.video_infos = [v for v in self.video_infos
                                if len(v['gts']) > 0]

        self.positive_pool: List[Tuple[str, SSNInstance]] = []
        self.incomplete_pool: List[Tuple[str, SSNInstance]] = []
        self.background_pool: List[Tuple[str, SSNInstance]] = []
        self._construct_proposal_pools()

        if reg_normalize_constants is None:
            self.reg_norm_consts = self._reg_normalize_constants()
        else:
            self.reg_norm_consts = np.asarray(reg_normalize_constants,
                                              np.float32)
        self.video_centric = video_centric
        self.body_segments = body_segments
        self.aug_segments = aug_segments
        self.aug_ratio = (aug_ratio, aug_ratio) if isinstance(
            aug_ratio, (int, float)) else tuple(aug_ratio)
        total = (self.sampler['positive_ratio'] +
                 self.sampler['background_ratio'] +
                 self.sampler['incomplete_ratio'])
        num = self.sampler['num_per_video']
        self.positive_per_video = int(
            num * self.sampler['positive_ratio'] / total)
        self.background_per_video = int(
            num * self.sampler['background_ratio'] / total)
        self.incomplete_per_video = (num - self.positive_per_video -
                                     self.background_per_video)
        self.clip_len = clip_len
        self.frame_interval = frame_interval
        self.use_regression = use_regression

    # ------------------------------------------------------------ loading
    def load_annotations(self):
        self.proposal_file = self.ann_file.replace('normalized_', '')
        video_infos = []
        for vid, num_frames, gt_rows, prop_rows in \
                load_localize_proposal_file(self.proposal_file):
            frame_dir = vid if self.data_prefix is None else \
                osp.join(self.data_prefix, vid)
            gts = [SSNInstance(int(r[1]), int(r[2]), num_frames,
                               label=int(r[0]), best_iou=1.0)
                   for r in gt_rows
                   if int(r[2]) > int(r[1]) and int(r[1]) < num_frames]
            proposals = [SSNInstance(int(r[3]), int(r[4]), num_frames,
                                     label=int(r[0]),
                                     best_iou=float(r[1]),
                                     overlap_self=float(r[2]))
                         for r in prop_rows
                         if int(r[4]) > int(r[3]) and
                         int(r[3]) < num_frames]
            video_infos.append(dict(frame_dir=frame_dir, video_id=vid,
                                    total_frames=num_frames, gts=gts,
                                    proposals=proposals, label=0))
        return video_infos

    # ------------------------------------------------------------ pools
    @staticmethod
    def get_positives(gts, proposals, positive_threshold, with_gt=True):
        positives = [p for p in proposals
                     if p.best_iou > positive_threshold]
        if with_gt:
            positives = positives + list(gts)
        for p in positives:
            p.compute_regression_targets(gts)
        return positives

    @staticmethod
    def get_negatives(proposals, incomplete_iou_threshold,
                      background_iou_threshold,
                      background_coverage_threshold=0.01,
                      incomplete_overlap_threshold=0.7):
        incompletes, backgrounds = [], []
        for p in proposals:
            if (p.best_iou < incomplete_iou_threshold and
                    p.overlap_self > incomplete_overlap_threshold):
                incompletes.append(p)
            elif (p.best_iou < background_iou_threshold and
                  p.coverage > background_coverage_threshold):
                backgrounds.append(p)
        return incompletes, backgrounds

    def _construct_proposal_pools(self):
        for info in self.video_infos:
            pos = self.get_positives(
                info['gts'], info['proposals'],
                self.assigner['positive_iou_threshold'],
                self.sampler.get('add_gt_as_proposals', True))
            self.positive_pool.extend(
                (info['video_id'], p) for p in pos)
            inc, bg = self.get_negatives(
                info['proposals'],
                self.assigner['incomplete_iou_threshold'],
                self.assigner['background_iou_threshold'],
                self.assigner.get('background_coverage_threshold', 0.01),
                self.assigner.get('incomplete_overlap_threshold', 0.7))
            self.incomplete_pool.extend(
                (info['video_id'], p) for p in inc)
            self.background_pool.extend(
                (info['video_id'], p) for p in bg)

    def _reg_normalize_constants(self):
        targets = []
        for info in self.video_infos:
            for p in self.get_positives(
                    info['gts'], info['proposals'],
                    self.assigner['positive_iou_threshold'], False):
                targets.append(list(p.regression_targets))
        if not targets:
            return np.array([[0., 0.], [1., 1.]], np.float32)
        t = np.asarray(targets, np.float32)
        std = np.maximum(t.std(axis=0), 1e-6)
        return np.stack([t.mean(axis=0), std])

    def get_all_gts(self):
        gts: Dict[int, Dict[str, list]] = {}
        for info in self.video_infos:
            for gt in info['gts']:
                rel = [gt.start_frame / info['total_frames'],
                       gt.end_frame / info['total_frames']]
                gts.setdefault(gt.label - 1, {}).setdefault(
                    info['video_id'], []).append(rel)
        return gts

    # --------------------------------------------------------- sampling
    def _sample_from(self, proposal_type, video_id, video_pool,
                     num_requested, dataset_pool):
        if num_requested == 0:
            return []
        if len(video_pool) == 0 and len(dataset_pool) == 0:
            return []
        if len(video_pool) == 0:
            idx = np.random.choice(len(dataset_pool), num_requested,
                                   replace=len(dataset_pool) <
                                   num_requested)
            return [(dataset_pool[i], proposal_type) for i in idx]
        idx = np.random.choice(len(video_pool), num_requested,
                               replace=len(video_pool) < num_requested)
        return [((video_id, video_pool[i]), proposal_type) for i in idx]

    def _video_centric_sampling(self, record):
        pos = self.get_positives(
            record['gts'], record['proposals'],
            self.assigner['positive_iou_threshold'],
            self.sampler.get('add_gt_as_proposals', True))
        inc, bg = self.get_negatives(
            record['proposals'],
            self.assigner['incomplete_iou_threshold'],
            self.assigner['background_iou_threshold'],
            self.assigner.get('background_coverage_threshold', 0.01),
            self.assigner.get('incomplete_overlap_threshold', 0.7))
        vid = record['video_id']
        out = []
        out += self._sample_from(0, vid, pos, self.positive_per_video,
                                 self.positive_pool)
        out += self._sample_from(1, vid, inc, self.incomplete_per_video,
                                 self.incomplete_pool)
        out += self._sample_from(2, vid, bg, self.background_per_video,
                                 self.background_pool)
        return out

    def _get_stage(self, proposal: SSNInstance, num_frames: int):
        start, end = proposal.start_frame, proposal.end_frame
        ori_clip_len = self.clip_len * self.frame_interval
        duration = end - start
        valid_starting = max(0, start - int(duration * self.aug_ratio[0]))
        valid_ending = min(num_frames - ori_clip_len + 1,
                           end - 1 + int(duration * self.aug_ratio[1]))
        valid_starting_length = start - valid_starting - ori_clip_len
        valid_ending_length = (valid_ending - end + 1) - ori_clip_len
        starting_scale = ((valid_starting_length + ori_clip_len + 1) /
                          (duration * self.aug_ratio[0]))
        ending_scale = ((valid_ending_length + ori_clip_len + 1) /
                        (duration * self.aug_ratio[1]))
        return starting_scale, ending_scale

    # ---------------------------------------------------------- prepare
    def prepare_train_frames(self, idx):
        results = copy.copy(self.video_infos[idx])
        results['filename_tmpl'] = self.filename_tmpl
        results['modality'] = self.modality
        results['start_index'] = self.start_index
        out_proposals = (self._video_centric_sampling(self.video_infos[idx])
                         if self.video_centric else
                         self._random_sampling())
        results['out_proposals'] = out_proposals

        scale_factors, types, labels, reg_targets = [], [], [], []
        for (vid, proposal), ptype in out_proposals:
            scale_factors.append(
                self._get_stage(proposal, proposal.num_video_frames))
            types.append(ptype)
            labels.append(0 if ptype == 2 else proposal.label)
            reg = proposal.regression_targets
            if ptype == 0:
                reg = ((reg[0] - self.reg_norm_consts[0][0]) /
                       self.reg_norm_consts[1][0],
                       (reg[1] - self.reg_norm_consts[0][1]) /
                       self.reg_norm_consts[1][1])
            reg_targets.append(reg)
        results['proposal_scale_factor'] = np.asarray(scale_factors,
                                                      np.float32)
        results['proposal_type'] = np.asarray(types, np.int32)
        results['proposal_labels'] = np.asarray(labels, np.int32)
        results['reg_targets'] = np.asarray(reg_targets, np.float32)
        return self.pipeline(results)

    def _random_sampling(self):
        out = []
        for pool, count, ptype in (
                (self.positive_pool, self.positive_per_video, 0),
                (self.incomplete_pool, self.incomplete_per_video, 1),
                (self.background_pool, self.background_per_video, 2)):
            idx = np.random.choice(len(pool), count,
                                   replace=len(pool) < count)
            out.extend((pool[i], ptype) for i in idx)
        return out

    def prepare_test_frames(self, idx):
        results = copy.copy(self.video_infos[idx])
        results['filename_tmpl'] = self.filename_tmpl
        results['modality'] = self.modality
        results['start_index'] = self.start_index
        proposals = list(results['proposals'])
        num_frames = results['total_frames']
        ori_clip_len = self.clip_len * self.frame_interval
        frame_ticks = np.arange(0, num_frames - ori_clip_len,
                                self.test_interval, dtype=int) + 1
        if not proposals:
            proposals = [SSNInstance(0, num_frames - 1, num_frames)]
        rel_list, tick_list, scale_list = [], [], []
        for p in proposals:
            rel = (p.start_frame / num_frames, p.end_frame / num_frames)
            dur = rel[1] - rel[0]
            rel_start = rel[0] - dur * self.aug_ratio[0]
            rel_end = rel[1] + dur * self.aug_ratio[1]
            real_start, real_end = max(0.0, rel_start), min(1.0, rel_end)
            scale_list.append(
                ((rel[0] - real_start) / (dur * self.aug_ratio[0]),
                 (real_end - rel[1]) / (dur * self.aug_ratio[1])))
            ticks = (np.array((real_start, *rel, real_end)) *
                     len(frame_ticks)).astype(np.int32)
            rel_list.append(rel)
            tick_list.append(ticks)
        results['relative_proposal_list'] = np.asarray(rel_list,
                                                       np.float32)
        results['scale_factor_list'] = np.asarray(scale_list, np.float32)
        results['proposal_tick_list'] = np.asarray(tick_list, np.int32)
        results['reg_norm_consts'] = self.reg_norm_consts
        return self.pipeline(results)

    # --------------------------------------------------------- evaluate
    def results_to_detections(self, results, top_k=2000, **kwargs):
        """reference ssn_dataset.py:331-394 — combine activity softmax
        with exp(completeness), keep top_k (class, proposal) entries."""
        num_classes = results[0]['activity_scores'].shape[1] - 1
        detections = [dict() for _ in range(num_classes)]
        for idx in range(len(self)):
            vid = self.video_infos[idx]['video_id']
            rel = np.asarray(results[idx]['relative_proposal_list'])
            rel = rel.reshape(-1, 2)
            act = np.asarray(results[idx]['activity_scores'], np.float64)
            comp = np.asarray(results[idx]['completeness_scores'],
                              np.float64)
            reg = results[idx].get('bbox_preds')
            if reg is None:
                reg = np.zeros((len(rel), num_classes, 2), np.float32)
            reg = np.asarray(reg).reshape(-1, num_classes, 2)
            e = np.exp(act[:, 1:] - act[:, 1:].max(axis=1, keepdims=True))
            combined = e / e.sum(axis=1, keepdims=True) * np.exp(comp)
            if top_k <= 0:
                for c in range(num_classes):
                    detections[c][vid] = np.concatenate(
                        [rel, combined[:, c:c + 1], reg[:, c, 0:1],
                         reg[:, c, 1:2]], axis=1)
            else:
                keep = np.argsort(combined.ravel())[-top_k:]
                for k in keep:
                    c, p = int(k % num_classes), int(k // num_classes)
                    row = np.array([[rel[p, 0], rel[p, 1],
                                     combined[p, c], reg[p, c, 0],
                                     reg[p, c, 1]]])
                    detections[c][vid] = row if vid not in detections[c] \
                        else np.vstack([detections[c][vid], row])
        return detections

    def evaluate(self, results, metrics=('mAP',), metric_options=None,
                 **kwargs):
        detections = self.results_to_detections(
            results, **(self.evaluater or {}))
        if self.use_regression:
            for class_idx in range(len(detections)):
                detections[class_idx] = {
                    vid: perform_regression(det)
                    for vid, det in detections[class_idx].items()}
        nms_thr = (self.evaluater or {}).get('nms', 0.4) \
            if isinstance(self.evaluater, dict) else 0.4
        for class_idx in range(len(detections)):
            detections[class_idx] = {
                vid: temporal_nms(det, nms_thr)
                for vid, det in detections[class_idx].items()}
        all_gts = self.get_all_gts()
        for class_idx in range(len(detections)):
            all_gts.setdefault(class_idx, {})
        iou_range = np.arange(0.1, 1.0, 0.1)
        ap_values = eval_ap(detections,
                            [all_gts[c] for c in range(len(detections))],
                            iou_range)
        map_ious = ap_values.mean(axis=0)
        out = {}
        for iou, v in zip(iou_range, map_ious):
            out[f'mAP@{iou:.02f}'] = float(v)
        return out
