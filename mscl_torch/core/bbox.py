"""RoI assignment, sampling and padded targets for AVA training, on the
host.

Port of ``mscl_tpu/core/bbox.py`` (reference
core/bbox/assigners/max_iou_assigner_ava.py, bbox_target.py and mmdet's
RandomSampler as the AVA configs set it), numpy, bit for bit given the
same ``np.random.Generator``. It runs in the input pipeline
(``AVAAssignSample``) and gives each clip ``num`` RoIs, padded, so every
step sees one shape.

- ``bbox_overlaps``: pairwise IoU of x1y1x2y2 boxes (no +1).
- ``MaxIoUAssignerAVA``: -1 don't care, 0 negative (max IoU in
  [0, neg_iou_thr) or the given range), i > 0 the gt i - 1 (max IoU at
  least ``pos_iou_thr``, its argmax); with ``match_low_quality`` each gt
  then claims its best proposals (all ties with ``gt_max_assign_all``) if
  that IoU reaches ``min_pos_iou``. A positive takes its gt's multilabel
  row; the rest all zeros.
- ``RandomSampler``: the gts first, as their own positives
  (``add_gt_as_proposals``); ``int(num * pos_fraction)`` positives drawn
  without replacement if there are more, then negatives up to ``num``
  (capped by ``neg_pos_ub`` times the positives).
- ``bbox_target``: positives, then negatives, then zero rows with weight
  0, to ``num``.

A sampler given no generator draws from one seeded from the global
``np.random`` stream (``host_rng``), where the JAX one takes an OS-seeded
``default_rng()``: a run seeded with ``--seed`` then repeats.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np


def host_rng(rng: Optional[np.random.Generator] = None
             ) -> np.random.Generator:
    """``rng``, or a generator seeded by one draw of the global stream."""
    if rng is not None:
        return rng
    return np.random.default_rng(np.random.randint(0, 2 ** 31 - 1))


def bbox_overlaps(boxes1: np.ndarray, boxes2: np.ndarray,
                  eps: float = 1e-6) -> np.ndarray:
    """Pairwise IoU, (n, 4) x (k, 4) -> (n, k) float32."""
    n, k = boxes1.shape[0], boxes2.shape[0]
    if n == 0 or k == 0:
        return np.zeros((n, k), np.float32)
    lt = np.maximum(boxes1[:, None, :2], boxes2[None, :, :2])
    rb = np.minimum(boxes1[:, None, 2:4], boxes2[None, :, 2:4])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area1 = ((boxes1[:, 2] - boxes1[:, 0]) *
             (boxes1[:, 3] - boxes1[:, 1]))[:, None]
    area2 = ((boxes2[:, 2] - boxes2[:, 0]) *
             (boxes2[:, 3] - boxes2[:, 1]))[None, :]
    return (inter / np.maximum(area1 + area2 - inter, eps)).astype(
        np.float32)


class MaxIoUAssignerAVA:

    def __init__(self, pos_iou_thr: float, neg_iou_thr,
                 min_pos_iou: float = 0.0, gt_max_assign_all: bool = True,
                 match_low_quality: bool = True, **kwargs):
        self.pos_iou_thr = pos_iou_thr
        self.neg_iou_thr = neg_iou_thr
        self.min_pos_iou = min_pos_iou
        self.gt_max_assign_all = gt_max_assign_all
        self.match_low_quality = match_low_quality

    def assign(self, proposals: np.ndarray, gt_bboxes: np.ndarray,
               gt_labels: np.ndarray) -> Dict[str, np.ndarray]:
        """proposals (n, 4), gt_bboxes (k, 4), gt_labels (k, C) ->
        dict(gt_inds (n,) int64, max_overlaps (n,), labels (n, C))."""
        overlaps = bbox_overlaps(gt_bboxes, proposals)  # (k, n)
        num_gts, num_bboxes = overlaps.shape
        gt_inds = np.full((num_bboxes,), -1, np.int64)
        n_classes = gt_labels.shape[1] if gt_labels.ndim == 2 else 0
        if num_gts == 0 or num_bboxes == 0:
            if num_gts == 0:
                gt_inds[:] = 0
            return dict(gt_inds=gt_inds,
                        max_overlaps=np.zeros((num_bboxes,), np.float32),
                        labels=np.zeros((num_bboxes, n_classes),
                                        np.float32))

        max_overlaps = overlaps.max(axis=0)
        argmax_overlaps = overlaps.argmax(axis=0)
        gt_max_overlaps = overlaps.max(axis=1)
        gt_argmax_overlaps = overlaps.argmax(axis=1)
        if isinstance(self.neg_iou_thr, (int, float)):
            neg = (max_overlaps >= 0) & (max_overlaps < self.neg_iou_thr)
        else:
            lo, hi = self.neg_iou_thr
            neg = (max_overlaps >= lo) & (max_overlaps < hi)
        gt_inds[neg] = 0
        pos = max_overlaps >= self.pos_iou_thr
        gt_inds[pos] = argmax_overlaps[pos] + 1
        if self.match_low_quality:
            for i in range(num_gts):
                if gt_max_overlaps[i] >= self.min_pos_iou:
                    if self.gt_max_assign_all:
                        gt_inds[overlaps[i] == gt_max_overlaps[i]] = i + 1
                    else:
                        gt_inds[gt_argmax_overlaps[i]] = i + 1

        labels = np.zeros((num_bboxes, n_classes), np.float32)
        pos_mask = gt_inds > 0
        if pos_mask.any():
            labels[pos_mask] = gt_labels[gt_inds[pos_mask] - 1]
        return dict(gt_inds=gt_inds, max_overlaps=max_overlaps,
                    labels=labels)


class RandomSampler:

    def __init__(self, num: int, pos_fraction: float,
                 neg_pos_ub: int = -1, add_gt_as_proposals: bool = True,
                 **kwargs):
        self.num = num
        self.pos_fraction = pos_fraction
        self.neg_pos_ub = neg_pos_ub
        self.add_gt_as_proposals = add_gt_as_proposals

    def sample(self, assign: Dict[str, np.ndarray], proposals: np.ndarray,
               gt_bboxes: np.ndarray, gt_labels: np.ndarray,
               rng: Optional[np.random.Generator] = None
               ) -> Dict[str, np.ndarray]:
        rng = host_rng(rng)
        gt_inds, labels = assign['gt_inds'], assign['labels']
        if self.add_gt_as_proposals and len(gt_bboxes) > 0:
            proposals = np.concatenate([gt_bboxes, proposals], axis=0)
            gt_inds = np.concatenate(
                [np.arange(1, len(gt_bboxes) + 1), gt_inds])
            labels = np.concatenate([gt_labels, labels], axis=0)

        pos_inds = np.flatnonzero(gt_inds > 0)
        neg_inds = np.flatnonzero(gt_inds == 0)
        num_expected_pos = int(self.num * self.pos_fraction)
        if len(pos_inds) > num_expected_pos:
            pos_inds = rng.choice(pos_inds, num_expected_pos, replace=False)
        num_expected_neg = self.num - len(pos_inds)
        if self.neg_pos_ub >= 0:
            num_expected_neg = min(
                num_expected_neg, self.neg_pos_ub * max(1, len(pos_inds)))
        if len(neg_inds) > num_expected_neg:
            neg_inds = rng.choice(neg_inds, num_expected_neg, replace=False)
        return dict(pos_bboxes=proposals[pos_inds],
                    neg_bboxes=proposals[neg_inds],
                    pos_labels=labels[pos_inds])


def bbox_target(pos_bboxes: np.ndarray, neg_bboxes: np.ndarray,
                pos_labels: np.ndarray, num: int, num_classes: int,
                pos_weight: float = 1.0
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(rois (num, 4), labels (num, num_classes), weights (num,)), the
    padding's weight 0."""
    pos_weight = 1.0 if pos_weight <= 0 else pos_weight
    n_pos, n_neg = len(pos_bboxes), len(neg_bboxes)
    rois = np.zeros((num, 4), np.float32)
    labels = np.zeros((num, num_classes), np.float32)
    weights = np.zeros((num,), np.float32)
    if n_pos:
        rois[:n_pos] = pos_bboxes[:, :4]
        labels[:n_pos] = pos_labels
        weights[:n_pos] = pos_weight
    if n_neg:
        rois[n_pos:n_pos + n_neg] = neg_bboxes[:, :4]
        weights[n_pos:n_pos + n_neg] = 1.0
    return rois, labels, weights


def assign_and_sample(proposals: np.ndarray, gt_bboxes: np.ndarray,
                      gt_labels: np.ndarray, rcnn_cfg: Dict,
                      rng: Optional[np.random.Generator] = None
                      ) -> Dict[str, np.ndarray]:
    """The assigner, the sampler and the padded targets as
    ``train_cfg.rcnn`` sets them: dict(rois, roi_labels, roi_weights)."""
    assigner_cfg = dict(rcnn_cfg['assigner'])
    assigner_cfg.pop('type', None)
    sampler_cfg = dict(rcnn_cfg['sampler'])
    sampler_cfg.pop('type', None)
    assigner = MaxIoUAssignerAVA(**assigner_cfg)
    sampler = RandomSampler(**sampler_cfg)
    assign = assigner.assign(proposals[:, :4], gt_bboxes, gt_labels)
    sampled = sampler.sample(assign, proposals[:, :4], gt_bboxes,
                             gt_labels, rng)
    rois, labels, weights = bbox_target(
        sampled['pos_bboxes'], sampled['neg_bboxes'],
        sampled['pos_labels'], num=sampler.num,
        num_classes=gt_labels.shape[1],
        pos_weight=rcnn_cfg.get('pos_weight', 1.0))
    return dict(rois=rois, roi_labels=labels, roi_weights=weights)
