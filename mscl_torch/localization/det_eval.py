"""Frame-level detection mAP (compact AVA/pascal protocol).

The port's own copy of ``mscl_tpu/localization/det_eval.py`` (host numpy,
held against it bitwise by tests/test_torch_localization_data.py).

Parity role: reference mmaction/core/evaluation/ava_evaluation — per
class: rank detections by score, greedy-match to ground truths at
IoU >= 0.5, AP by all-point precision-recall interpolation.
"""
from __future__ import annotations

import numpy as np


def box_iou(boxes1: np.ndarray, boxes2: np.ndarray) -> np.ndarray:
    """(N, 4) x (M, 4) xyxy -> (N, M) IoU."""
    if len(boxes1) == 0 or len(boxes2) == 0:
        return np.zeros((len(boxes1), len(boxes2)))
    x1 = np.maximum(boxes1[:, None, 0], boxes2[None, :, 0])
    y1 = np.maximum(boxes1[:, None, 1], boxes2[None, :, 1])
    x2 = np.minimum(boxes1[:, None, 2], boxes2[None, :, 2])
    y2 = np.minimum(boxes1[:, None, 3], boxes2[None, :, 3])
    inter = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
    a1 = (boxes1[:, 2] - boxes1[:, 0]) * (boxes1[:, 3] - boxes1[:, 1])
    a2 = (boxes2[:, 2] - boxes2[:, 0]) * (boxes2[:, 3] - boxes2[:, 1])
    union = a1[:, None] + a2[None, :] - inter
    return np.where(union > 0, inter / union, 0.0)


def _average_precision(recall, precision):
    """All-point interpolated AP."""
    mrec = np.concatenate([[0], recall, [1]])
    mpre = np.concatenate([[0], precision, [0]])
    for i in range(len(mpre) - 2, -1, -1):
        mpre[i] = max(mpre[i], mpre[i + 1])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def frame_map(detections, ground_truths, num_classes, iou_thr=0.5):
    """detections / ground_truths: per-frame lists of dicts with
    'bboxes' (N, 4) and ('scores' (N, C) | 'labels' (N, C) one-hot).
    Returns mean AP over classes with at least one gt (class 0, the
    person/background slot, is skipped — AVA convention)."""
    aps = []
    for c in range(1, num_classes):
        records = []  # (score, frame_idx, det_idx)
        n_gt = 0
        gt_boxes_per_frame = []
        for f, gt in enumerate(ground_truths):
            mask = gt['labels'][:, c] > 0.5 if len(gt['labels']) else \
                np.zeros((0,), bool)
            gt_boxes_per_frame.append(gt['bboxes'][mask]
                                      if len(gt['bboxes']) else
                                      np.zeros((0, 4)))
            n_gt += int(mask.sum())
        if n_gt == 0:
            continue
        for f, det in enumerate(detections):
            scores = det['scores'][:, c] if len(det['scores']) else []
            for d, s in enumerate(scores):
                records.append((float(s), f, d))
        if not records:
            aps.append(0.0)
            continue
        records.sort(key=lambda r: -r[0])
        matched = [np.zeros(len(g), bool) for g in gt_boxes_per_frame]
        tp = np.zeros(len(records))
        fp = np.zeros(len(records))
        for i, (s, f, d) in enumerate(records):
            gt_boxes = gt_boxes_per_frame[f]
            if len(gt_boxes) == 0:
                fp[i] = 1
                continue
            det_box = detections[f]['bboxes'][d][None]
            ious = box_iou(det_box, gt_boxes)[0]
            j = int(np.argmax(ious))
            if ious[j] >= iou_thr and not matched[f][j]:
                tp[i] = 1
                matched[f][j] = True
            else:
                fp[i] = 1
        ctp = np.cumsum(tp)
        cfp = np.cumsum(fp)
        recall = ctp / n_gt
        precision = ctp / np.maximum(ctp + cfp, 1e-12)
        aps.append(_average_precision(recall, precision))
    return float(np.mean(aps)) if aps else 0.0


class ActivityNetDetection:
    """Temporal-detection mAP on ActivityNet-format json files.

    Parity: reference mmaction/core/evaluation/eval_detection.py
    ActivityNetLocalization — ground truth json maps video ids (with a
    2-char 'v_' prefix, stripped on load, eval_detection.py:81) to
    ``annotations: [{segment, label}]``; the prediction json carries
    ``results: {video_id: [{segment, label, score}]}``. Per class, AP
    uses the greedy highest-IoU lock matching + interpolated PR
    integration (compute_average_precision_detection semantics), here
    delegated to ssn_utils.average_precision_at_temporal_iou which
    implements exactly that protocol.
    """

    def __init__(self, ground_truth_filename=None,
                 prediction_filename=None,
                 tiou_thresholds=None, verbose=False):
        import json
        if not ground_truth_filename:
            raise IOError('Please input a valid ground truth file.')
        if not prediction_filename:
            raise IOError('Please input a valid prediction file.')
        self.tiou_thresholds = (np.linspace(0.5, 0.95, 10)
                                if tiou_thresholds is None
                                else np.asarray(tiou_thresholds))
        self.verbose = verbose
        with open(ground_truth_filename) as f:
            gt_data = json.load(f)
        self.activity_index = {}
        # per class: {video_id: (k, 2) [t_start, t_end]}
        self.gt_by_class = {}
        n_gt = 0
        for video_id, info in gt_data.items():
            vid = video_id[2:]          # strip the 'v_' prefix
            for anno in info['annotations']:
                label = anno['label']
                if label not in self.activity_index:
                    self.activity_index[label] = len(self.activity_index)
                seg = [float(anno['segment'][0]),
                       float(anno['segment'][1])]
                self.gt_by_class.setdefault(label, {}).setdefault(
                    vid, []).append(seg)
                n_gt += 1
        with open(prediction_filename) as f:
            pred_data = json.load(f)
        # per class: rows [video_id, class_id, t_start, t_end, score]
        self.pred_by_class = {}
        n_pred = 0
        for video_id, results in pred_data['results'].items():
            for r in results:
                label = r['label']
                if label not in self.activity_index:
                    continue            # class absent from ground truth
                self.pred_by_class.setdefault(label, []).append(
                    [video_id, self.activity_index[label],
                     float(r['segment'][0]), float(r['segment'][1]),
                     float(r['score'])])
                n_pred += 1
        if verbose:
            print(f'[INIT] {n_gt} ground truth instances, '
                  f'{n_pred} predictions, '
                  f'tiou thresholds {self.tiou_thresholds}')

    def evaluate(self):
        """Returns (mAP per tiou threshold, average mAP)."""
        from .ssn_utils import average_precision_at_temporal_iou
        ap = np.zeros((len(self.tiou_thresholds),
                       len(self.activity_index)))
        for label, cls_idx in self.activity_index.items():
            gts = {vid: np.asarray(v)
                   for vid, v in self.gt_by_class.get(label, {}).items()}
            preds = self.pred_by_class.get(label, [])
            ap[:, cls_idx] = average_precision_at_temporal_iou(
                gts, preds, self.tiou_thresholds)
        self.ap = ap
        self.mAP = ap.mean(axis=1)
        self.average_mAP = float(self.mAP.mean())
        return self.mAP, self.average_mAP


# reference-name alias (mmaction.core.ActivityNetLocalization)
ActivityNetLocalization = ActivityNetDetection
