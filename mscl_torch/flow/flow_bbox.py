"""Motion pseudo-boxes from optical flow (port of
``mscl_tpu/flow/flow_bbox.py``, reference tools/ARFlow/flow_utils.py:14-485,
consumed by the flow2img tool's ``inference_bboxs``): the MoSI-style
moving-object discovery that turns flow maps into smoothed pseudo-box
sequences (``gt_bboxes``).

  1. flow_to_bbox: per-frame distance map |flow - mean_flow|_2,
     saliency-gated binarization at two (mean, max)-mixed thresholds,
     connected components (scipy.ndimage), box scoring by area +
     centerness with max-distance award / corner penalties
  2. smooth_bbox_dp: dynamic programming over candidate boxes with the
     modified-DIoU transition reward and a constant per-box reward, then
     linear interpolation between selected keyframes (keeping the
     reference's documented 'reversed-ratio' interpolation quirk)
  3. calc_nearby_bbox_freq / calc_corner_bbox_freq: frame- and
     video-quality statistics used to filter high-quality videos

Host numpy and scipy, as the JAX module is: the same operations in the same
order, so the boxes and statistics are the JAX module's bit for bit
(``smooth_bbox_dp``'s jitter draws from the global ``np.random`` as there).
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
from scipy import ndimage


def _clean_mask(mask: np.ndarray, min_size: int = 80) -> np.ndarray:
    """remove_small_objects + remove_small_holes via scipy.ndimage."""
    def drop_small(m):
        labels, n = ndimage.label(m)
        if n == 0:
            return m
        sizes = ndimage.sum_labels(m, labels, index=np.arange(1, n + 1))
        keep = np.zeros(n + 1, bool)
        keep[1:] = sizes >= min_size
        return keep[labels]

    mask = drop_small(mask)
    holes_removed = ~drop_small(~mask)
    return holes_removed


def IOU(bbox1, bbox2) -> float:
    s1 = (bbox1[2] - bbox1[0]) * (bbox1[3] - bbox1[1])
    s2 = (bbox2[2] - bbox2[0]) * (bbox2[3] - bbox2[1])
    left = max(bbox1[1], bbox2[1])
    right = min(bbox1[3], bbox2[3])
    top = max(bbox1[0], bbox2[0])
    bottom = min(bbox1[2], bbox2[2])
    if left >= right or top >= bottom:
        return 0.0
    inter = (right - left) * (bottom - top)
    return inter / (s1 + s2 - inter)


def DIOU_modify(bbox1, bbox2) -> float:
    """Modified DIoU (reference flow_utils.py:211-259): distance
    penalty x4.1, negative values x3."""
    b1 = np.asarray(bbox1, np.float64)
    b2 = np.asarray(bbox2, np.float64)
    area1 = (b1[2] - b1[0]) * (b1[3] - b1[1])
    area2 = (b2[2] - b2[0]) * (b2[3] - b2[1])
    c1 = (b1[:2] + b1[2:]) / 2
    c2 = (b2[:2] + b2[2:]) / 2
    inter = np.clip(np.minimum(b1[2:], b2[2:]) -
                    np.maximum(b1[:2], b2[:2]), 0, 5000)
    inter_area = inter[0] * inter[1]
    inter_diag = ((c2 - c1) ** 2).sum()
    outer = np.clip(np.maximum(b1[2:], b2[2:]) -
                    np.minimum(b1[:2], b2[:2]), 0, 5000)
    outer_diag = (outer ** 2).sum()
    union = area1 + area2 - inter_area
    diou = inter_area / union - (inter_diag / outer_diag) * 4.1
    return float(diou * 3 if diou < 0 else diou)


def _boxes_at_threshold(distance, mean_distance, max_distance,
                        center_weight, mean_max_ratio, saliency_param,
                        top_n=1, area_weight=1.0, small_ratio=0.02,
                        border_ratio=0.7):
    """flow_to_bbox_single_group_param (reference :329-425)."""
    h_c, w_c = distance.shape
    max_dis_index = np.unravel_index(np.argmax(distance),
                                     distance.shape)
    scored = []
    if not (mean_distance < 0.05 or
            max_distance / max(mean_distance, 1e-12) > saliency_param):
        return []
    threshold = (mean_max_ratio * mean_distance +
                 (1 - mean_max_ratio) * max_distance)
    mask = _clean_mask(distance >= threshold)
    labels, n = ndimage.label(mask)
    for sl in ndimage.find_objects(labels):
        if sl is None:
            continue
        y0, y1 = sl[0].start, sl[0].stop
        x0, x1 = sl[1].start, sl[1].stop
        if (y1 - y0) < h_c * small_ratio or (x1 - x0) < w_c * small_ratio:
            continue
        area = (y1 - y0) * (x1 - x0)
        if area < 50:
            continue
        score = (center_weight * min(h_c - y1, y0) * min(w_c - x1, x0) +
                 area_weight * area)
        if y0 <= max_dis_index[0] <= y1 and x0 <= max_dis_index[1] <= x1:
            score *= 2
        if min(h_c - y1, y0) <= 15:
            score /= 2
            if (x1 - x0) > w_c * border_ratio:
                continue
        if min(w_c - x1, x0) <= 15:
            score /= 2
            if (y1 - y0) > h_c * border_ratio:
                continue
        if y1 == y0 or (x1 - x0) / (y1 - y0) > 6:
            continue
        if x1 == x0 or (y1 - y0) / (x1 - x0) > 6:
            continue
        scored.append((score, (x0, y0, x1, y1)))
    scored.sort(key=lambda s: -s[0])
    return [b for _, b in scored[:top_n]]


def flow_to_bbox(flow: np.ndarray, cut_ratio: float = 1 / 32
                 ) -> List[Tuple[float, float, float, float]]:
    """Candidate motion boxes for one flow map (reference :274-326)."""
    h, w = flow.shape[:2]
    clip = flow[int(h * cut_ratio):int(h * (1 - cut_ratio)),
                int(w * cut_ratio):int(w * (1 - cut_ratio))]
    mean_flow = clip.mean(axis=(0, 1))
    distance = np.sqrt(((clip - mean_flow) ** 2).sum(axis=2))
    max_d, mean_d = distance.max(), distance.mean()
    boxes = []
    for mean_max_ratio, center_weight in ((0.7, 0.5), (0.84, 0.5)):
        boxes += _boxes_at_threshold(distance, mean_d, max_d,
                                     center_weight, mean_max_ratio,
                                     saliency_param=2.5)
    return boxes


def smooth_bbox_dp(bboxes: Sequence[Sequence], length: int, gap: int = 3,
                   adjacent: int = 0, bbox_reward: float = -0.091,
                   max_dp_gap: int = 100):
    """DP box-sequence selection + interpolation (reference :14-182).

    bboxes: per-sampled-frame candidate lists (frames gap..length-gap
    step gap). Returns (smoothed (length,4) boxes, picked_frame_index,
    bbox_found_freq, bbox_picked_freq, aver_vary)."""
    candidates = []
    bbox_found_num = 0
    for bbox_index, frame_index in enumerate(
            range(gap, length - gap, gap)):
        if bbox_index < len(bboxes) and len(bboxes[bbox_index]) > 0:
            bbox_found_num += 1
            candidates.append((bboxes[bbox_index], frame_index))
    if not candidates:
        full = [(0.0, 0.0, 1.0, 1.0)] * length
        return full, [], 0.0, 0.0, 0.0

    min_dist = [[bbox_reward] * len(candidates[0][0])]
    back = [[(-1, -1)] * len(candidates[0][0])]
    for nr in range(1, len(candidates)):
        boxes, _ = candidates[nr]
        dists, links = [], []
        for box in boxes:
            best = bbox_reward
            best_link = (-1, -1)
            for dp in range(max(0, nr - max_dp_gap), nr):
                for sub, last_box in enumerate(candidates[dp][0]):
                    d = (min_dist[dp][sub] - DIOU_modify(box, last_box) +
                         bbox_reward)
                    if d <= best:
                        best = d
                        best_link = (dp, sub)
            dists.append(best)
            links.append(best_link)
        min_dist.append(dists)
        back.append(links)

    # path end = global minimum, trace back
    last = (len(candidates) - 1, 0)
    best = min_dist[last[0]][last[1]]
    for nr in range(len(candidates) - 1, -1, -1):
        for sub in range(len(candidates[nr][0])):
            if min_dist[nr][sub] <= best:
                last = (nr, sub)
                best = min_dist[nr][sub]
    picked = []
    while last[1] != -1:
        boxes, frame_index = candidates[last[0]]
        picked.insert(0, (boxes[last[1]], frame_index))
        last = back[last[0]][last[1]]

    # interpolate / extend into a full-length sequence
    out = []
    picked_frame_index = []
    last_gen = -1
    for pi, (box, frame_index) in enumerate(picked):
        picked_frame_index.append(frame_index)
        for j in range(last_gen + 1, frame_index):
            if pi == 0:
                if min(box) < 75:
                    out.append(box)
                else:
                    out.append(tuple(
                        np.asarray(box) +
                        np.random.uniform(-3, 3, size=4)))
            else:
                last_box, _ = picked[pi - 1]
                # the reference's documented 'reversed' interpolation
                # ratio is reproduced verbatim (flow_utils.py:120-139)
                ratio = (j - last_gen) / (frame_index - last_gen)
                out.append(tuple(
                    np.asarray(last_box) * ratio +
                    np.asarray(box) * (1 - ratio)))
        out.append(box)
        last_gen = frame_index
    last_box = out[-1]
    while len(out) < length:
        if min(last_box) < 50:
            out.append(last_box)
        else:
            out.append(tuple(np.asarray(last_box) +
                             np.random.uniform(-3, 3, size=4)))

    total_vary = sum(
        abs(a - b) for i in range(length - 1)
        for a, b in zip(out[i], out[i + 1]))
    aver_vary = total_vary / (length - 1)
    bbox_picked_freq = len(picked) / max(len(bboxes), 1)
    bbox_found_freq = bbox_found_num / max(len(bboxes), 1)
    return out, picked_frame_index, bbox_found_freq, \
        bbox_picked_freq, aver_vary


def calc_nearby_bbox_freq(picked_frame_index, video_length,
                          search_range=None, gap: int = 3):
    """Frame quality: DP-selection frequency among adjacent frames
    (reference :417-462)."""
    if not search_range:
        search_range = [3, 10]
    search_range = [s * gap for s in search_range]
    freq = [[0] * video_length for _ in search_range]
    freq_max = [[0] * video_length for _ in search_range]
    for r_i, sr in enumerate(search_range):
        for v_i in range(gap, video_length - gap, gap):
            for sub_i in range(max(0, v_i - sr),
                               min(video_length - 1, v_i + sr) + 1):
                freq_max[r_i][sub_i] += 1
        for v_i in picked_frame_index:
            for sub_i in range(max(0, v_i - sr),
                               min(video_length - 1, v_i + sr) + 1):
                freq[r_i][sub_i] += 1
    return [[(freq[r][v] / freq_max[r][v]) if freq_max[r][v] else 0.0
             for r in range(len(search_range))]
            for v in range(video_length)]


def calc_corner_bbox_freq(smoothed_bboxes, img_shape,
                          cut_ratio: float = 1 / 32) -> float:
    """Fraction of boxes stuck at corners/margins (reference :465-484)."""
    extreme = [int(cut_ratio * img_shape[1]),
               int(cut_ratio * img_shape[0]),
               int((1 - cut_ratio) * img_shape[1]),
               int((1 - cut_ratio) * img_shape[0])]
    n = 0.0
    for x1, y1, x2, y2 in smoothed_bboxes:
        x_c = x1 < extreme[0] + 10 or x2 > extreme[2] - 10
        y_c = y1 < extreme[1] + 10 or y2 > extreme[3] - 10
        if x_c and y_c:
            n += 1
        elif x_c or y_c:
            n += 0.3
    return n / len(smoothed_bboxes)


def inference_bboxs(im_length: int, flows: Sequence[np.ndarray],
                    gap: int = 2, adjacent: int = 8):
    """flow maps -> smoothed pseudo-box sequence + quality stats
    (reference tools/misc/flow2img.py:50-88)."""
    candidates = [flow_to_bbox(flow) for flow in flows]
    boxes, picked, found_freq, picked_freq, aver_vary = smooth_bbox_dp(
        candidates, length=im_length, gap=gap, adjacent=adjacent)
    freq_dict = calc_nearby_bbox_freq(picked, video_length=len(boxes),
                                      search_range=[3, 10], gap=gap)
    corner_freq = calc_corner_bbox_freq(
        boxes, img_shape=flows[0].shape) if len(boxes) else 1.0
    return boxes, picked, (freq_dict, found_freq, picked_freq,
                           aver_vary, corner_freq)
