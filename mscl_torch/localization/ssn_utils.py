"""SSN proposal-file IO, temporal NMS/regression, and AP evaluation.

The port's own copy of ``mscl_tpu/localization/ssn_utils.py`` (host numpy,
held against it bitwise by tests/test_torch_localization_data.py).

Parity: reference mmaction/localization/ssn_utils.py:10-160 (proposal
file format, regression decode, temporal NMS, eval_ap) and
core/evaluation/accuracy.py:481-560 (AP at temporal IoU, greedy
highest-IoU matching with per-threshold gt locking). Fresh numpy
implementations of the same protocols.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from .proposal_utils import temporal_iou


def load_localize_proposal_file(filename: str) -> List:
    """Parse the SSN 'standard' proposal text file.

    Per-video block format (reference ssn_utils.py docstring):
        # <index>
        video_id
        num_frames_or_duration
        fps_or_1
        num_gts
        <label start end> x num_gts
        num_proposals
        <label best_iou overlap_self start end> x num_proposals

    Returns a list of (video_id, num_frames, gt_rows, proposal_rows)
    with rows kept as string lists (caller converts types).
    """
    with open(filename) as f:
        lines = [ln.strip() for ln in f]

    infos = []
    i = 0
    n = len(lines)
    while i < n:
        if not lines[i].startswith('#'):
            i += 1
            continue
        i += 1
        video_id = lines[i]
        num_frames = int(float(lines[i + 1]) * float(lines[i + 2]))
        num_gts = int(lines[i + 3])
        i += 4
        gts = [lines[i + j].split() for j in range(num_gts)]
        i += num_gts
        num_props = int(lines[i])
        i += 1
        props = [lines[i + j].split() for j in range(num_props)]
        i += num_props
        infos.append((video_id, num_frames, gts, props))
    return infos


def perform_regression(detections: np.ndarray) -> np.ndarray:
    """Decode (loc, size) regression on [start, end, score, loc, size]
    rows (reference ssn_utils.py perform_regression)."""
    starts, ends = detections[:, 0], detections[:, 1]
    centers = (starts + ends) / 2
    durations = ends - starts
    new_centers = centers + durations * detections[:, 3]
    new_durations = durations * np.exp(detections[:, 4])
    out = detections.copy()
    out[:, 0] = np.clip(new_centers - new_durations / 2, 0, 1)
    out[:, 1] = np.clip(new_centers + new_durations / 2, 0, 1)
    return out


def temporal_nms(detections: np.ndarray, threshold: float) -> np.ndarray:
    """Greedy temporal NMS on [start, end, score, ...] rows."""
    starts, ends = detections[:, 0], detections[:, 1]
    order = detections[:, 2].argsort()[::-1]
    keep = []
    while order.size > 0:
        i = order[0]
        keep.append(i)
        ious = temporal_iou(starts[order[1:]], ends[order[1:]],
                            starts[i], ends[i])
        order = order[1:][np.asarray(ious) <= threshold]
    return detections[keep]


def average_precision_at_temporal_iou(
        ground_truth: Dict[str, np.ndarray], prediction: Sequence,
        temporal_iou_thresholds=(0.5,)) -> np.ndarray:
    """AP with greedy highest-IoU matching; a gt segment may match only
    one prediction per threshold (reference accuracy.py:481-560).

    ground_truth: {video_id: (k, 2) [t_start, t_end]}.
    prediction: rows [video_id, class_id, t_start, t_end, score].
    """
    thr = np.asarray(temporal_iou_thresholds, np.float32)
    ap = np.zeros(len(thr), np.float32)
    if len(prediction) == 0:
        return ap
    num_gts = sum(len(v) for v in ground_truth.values())
    if num_gts == 0:
        return ap
    lock = {k: -np.ones((len(thr), len(v)), np.int64)
            for k, v in ground_truth.items()}

    pred = sorted(prediction, key=lambda r: -float(r[4]))
    tp = np.zeros((len(thr), len(pred)), np.int32)
    fp = np.zeros((len(thr), len(pred)), np.int32)
    for idx, row in enumerate(pred):
        vid = row[0]
        if vid not in ground_truth:
            fp[:, idx] = 1
            continue
        gt = np.asarray(ground_truth[vid], float)
        ious = np.asarray(temporal_iou(gt[:, 0], gt[:, 1],
                                       float(row[2]), float(row[3])))
        order = ious.argsort()[::-1]
        for t_idx, t in enumerate(thr):
            matched = False
            for j in order:
                if ious[j] < t:
                    break
                if lock[vid][t_idx, j] >= 0:
                    continue
                lock[vid][t_idx, j] = idx
                tp[t_idx, idx] = 1
                matched = True
                break
            if not matched:
                fp[t_idx, idx] = 1

    tp_cum = np.cumsum(tp, axis=1).astype(np.float64)
    fp_cum = np.cumsum(fp, axis=1).astype(np.float64)
    recall = tp_cum / num_gts
    precision = tp_cum / np.maximum(tp_cum + fp_cum, 1e-12)
    for t_idx in range(len(thr)):
        # interpolated AP (VOC-style envelope + integration)
        mrec = np.concatenate([[0.], recall[t_idx], [1.]])
        mpre = np.concatenate([[0.], precision[t_idx], [0.]])
        for i in range(len(mpre) - 1, 0, -1):
            mpre[i - 1] = max(mpre[i - 1], mpre[i])
        pts = np.where(mrec[1:] != mrec[:-1])[0]
        ap[t_idx] = float(np.sum(
            (mrec[pts + 1] - mrec[pts]) * mpre[pts + 1]))
    return ap


def eval_ap(detections: Sequence[Dict], gt_by_cls: Sequence[Dict],
            iou_range: Sequence[float]) -> np.ndarray:
    """Per-class AP at each IoU (reference ssn_utils.py eval_ap).

    detections[c]: {video_id: (n, >=3) [start, end, score, ...]}.
    gt_by_cls[c]: {video_id: (k, 2)}.
    """
    ap_values = np.zeros((len(detections), len(iou_range)), np.float32)
    for class_idx, dets in enumerate(detections):
        rows = []
        for vid, arr in dets.items():
            for r in np.asarray(arr):
                rows.append([vid, class_idx, r[0], r[1], r[2]])
        for iou_idx, min_overlap in enumerate(iou_range):
            ap_values[class_idx, iou_idx] = average_precision_at_temporal_iou(
                gt_by_cls[class_idx], rows, [min_overlap])[0]
    return ap_values
