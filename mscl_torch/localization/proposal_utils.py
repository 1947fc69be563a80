"""Temporal proposal utilities: IoU/IoP, soft-NMS, BMN post-processing.

The port's own copy of ``mscl_tpu/localization/proposal_utils.py`` (host numpy,
held against it bitwise by tests/test_torch_localization_data.py).

Parity: reference mmaction/localization/proposal_utils.py:5-100 and the
BSN/BMN post_processing path (host-side numpy — runs per video after the
jitted forward).
"""
from __future__ import annotations

import numpy as np


def temporal_iou(proposal_min, proposal_max, gt_min, gt_max):
    """Jaccard overlap of temporal segments (vectorized)."""
    len_anchors = proposal_max - proposal_min
    int_tmin = np.maximum(proposal_min, gt_min)
    int_tmax = np.minimum(proposal_max, gt_max)
    inter_len = np.maximum(int_tmax - int_tmin, 0.)
    union_len = len_anchors - inter_len + gt_max - gt_min
    return np.divide(inter_len, union_len,
                     out=np.zeros_like(inter_len, dtype=np.float64),
                     where=union_len != 0)


def temporal_iop(proposal_min, proposal_max, gt_min, gt_max):
    """Intersection over proposal length."""
    len_anchors = np.array(proposal_max - proposal_min)
    int_tmin = np.maximum(proposal_min, gt_min)
    int_tmax = np.minimum(proposal_max, gt_max)
    inter_len = np.maximum(int_tmax - int_tmin, 0.)
    return np.divide(inter_len, len_anchors,
                     out=np.zeros_like(inter_len, dtype=np.float64),
                     where=len_anchors != 0)


def soft_nms(proposals, alpha, low_threshold, high_threshold, top_k):
    """Gaussian soft-NMS over [tmin, tmax, ..., score] rows
    (reference proposal_utils.py:49-100)."""
    proposals = proposals[proposals[:, -1].argsort()[::-1]]
    tstart = list(proposals[:, 0])
    tend = list(proposals[:, 1])
    tscore = list(proposals[:, -1])
    rstart, rend, rscore = [], [], []

    while len(tscore) > 0 and len(rscore) <= top_k:
        max_index = int(np.argmax(tscore))
        max_width = tend[max_index] - tstart[max_index]
        iou_list = temporal_iou(tstart[max_index], tend[max_index],
                                np.array(tstart), np.array(tend))
        iou_exp_list = np.exp(-np.square(iou_list) / alpha)
        for idx, _ in enumerate(tscore):
            if idx != max_index:
                current_iou = iou_list[idx]
                if current_iou > low_threshold + (
                        high_threshold - low_threshold) * max_width:
                    tscore[idx] = tscore[idx] * iou_exp_list[idx]
        rstart.append(tstart[max_index])
        rend.append(tend[max_index])
        rscore.append(tscore[max_index])
        tstart.pop(max_index)
        tend.pop(max_index)
        tscore.pop(max_index)

    rstart = np.array(rstart).reshape(-1, 1)
    rend = np.array(rend).reshape(-1, 1)
    rscore = np.array(rscore).reshape(-1, 1)
    return np.concatenate((rstart, rend, rscore), axis=1)


def post_processing(result, video_info, soft_nms_alpha,
                    soft_nms_low_threshold, soft_nms_high_threshold,
                    post_process_top_k, feature_extraction_interval=16):
    """Proposal post-processing (reference bsn_utils post_processing):
    soft-NMS, sort, convert to second-units with the video duration."""
    if len(result) > 1:
        result = soft_nms(result, soft_nms_alpha, soft_nms_low_threshold,
                          soft_nms_high_threshold, post_process_top_k)
    result = result[result[:, -1].argsort()[::-1]]
    video_duration = float(
        video_info['duration_frame'] // feature_extraction_interval *
        feature_extraction_interval) / video_info['duration_frame'] * \
        video_info['duration_second']
    proposal_list = []
    for j in range(min(post_process_top_k, len(result))):
        proposal_list.append(dict(
            score=float(result[j, -1]),
            segment=[max(0., float(result[j, 0])) * video_duration,
                     min(1., float(result[j, 1])) * video_duration]))
    return proposal_list


def average_recall_at_avg_proposals(ground_truth, proposals,
                                    total_num_proposals,
                                    max_avg_proposals=100,
                                    temporal_iou_thresholds=None):
    """AR@AN curve (reference mmaction/core/evaluation/eval_detection
    style): returns (recall matrix, average recall, proposals-per-video,
    AUC)."""
    if temporal_iou_thresholds is None:
        temporal_iou_thresholds = np.linspace(0.5, 0.95, 10)
    video_names = list(ground_truth)
    num_videos = len(video_names)
    ratio = (max_avg_proposals * num_videos /
             max(total_num_proposals, 1))
    pcn_list = np.arange(1, 101) / 100.0 * ratio

    matches = []
    total_gts = 0
    for vid in video_names:
        gts = np.array(ground_truth[vid])
        total_gts += len(gts)
        props = proposals.get(vid, np.empty((0, 3)))
        if len(props) == 0 or len(gts) == 0:
            matches.append((np.zeros((len(gts), 0)), len(props)))
            continue
        props = props[props[:, 2].argsort()[::-1]]
        iou = np.stack([
            temporal_iou(props[:, 0], props[:, 1], g[0], g[1])
            for g in gts])  # (n_gt, n_prop)
        matches.append((iou, len(props)))

    recall = np.zeros((len(temporal_iou_thresholds), len(pcn_list)))
    for ti, thr in enumerate(temporal_iou_thresholds):
        for pi, pcn in enumerate(pcn_list):
            hit = 0
            for iou, n_props in matches:
                k = max(int(round(pcn * max_avg_proposals)), 1)
                if iou.shape[1] == 0:
                    continue
                hit += int((iou[:, :min(k, iou.shape[1])] >= thr)
                           .any(axis=1).sum())
            recall[ti, pi] = hit / max(total_gts, 1)
    avg_recall = recall.mean(axis=0)
    proposals_per_video = pcn_list * max_avg_proposals
    # np.trapz before numpy 2.0
    trapezoid = getattr(np, 'trapezoid', None) or np.trapz
    auc = trapezoid(avg_recall, proposals_per_video) / max_avg_proposals
    return recall, avg_recall, proposals_per_video, auc
