"""BSN proposal-generation module (PGM) utilities.

The port's own copy of ``mscl_tpu/localization/bsn_utils.py`` (host numpy,
held against it bitwise by tests/test_torch_localization_data.py).

Parity: reference mmaction/localization/bsn_utils.py:9-280 —
  - generate_candidate_proposals: peak-pick start/end probability
    curves from TEM outputs (local maxima or > peak_threshold * max),
    cross start x end into candidate proposals scored
    tmin_score * tmax_score, annotate match_iou / match_ioa against gt
  - generate_bsp_feature: boundary-sensitive proposal features —
    interpolate the (zero-extended) actionness curve at
    num_sample_interp-averaged points over the start / action / end
    regions of each top-k proposal

The reference reads/writes per-video csv files; these accept either a
csv directory (reference layout: header row then
'action,start,end,tmin,tmax' columns for TEM and
'tmin,tmax,tmin_score,tmax_score,score,match_iou,match_ioa' for
proposals) or in-memory {video_name: ndarray} dicts.
"""
from __future__ import annotations

import os.path as osp
from typing import Dict, List, Optional, Sequence

import numpy as np

from .proposal_utils import temporal_iop, temporal_iou


def _load_csv_or_dict(source, video_name, ext='.csv'):
    if isinstance(source, dict):
        return np.asarray(source[video_name], np.float32)
    return np.loadtxt(osp.join(source, video_name + ext),
                      dtype=np.float32, delimiter=',', skiprows=1)


def generate_candidate_proposals(video_list: Sequence[int],
                                 video_infos: List[Dict],
                                 tem_results,
                                 temporal_scale: int,
                                 peak_threshold: float,
                                 result_dict: Optional[Dict] = None
                                 ) -> Dict[str, np.ndarray]:
    """tem_results rows: (action, start, end[, tmin, tmax]) per temporal
    position. Returns {video_name: (P, 7) [tmin, tmax, tmin_score,
    tmax_score, score, match_iou, match_ioa]}."""
    tscale = temporal_scale
    tgap = 1.0 / tscale
    proposal_dict = {}
    for vi in video_list:
        info = video_infos[vi]
        name = info['video_name']
        tem = _load_csv_or_dict(tem_results, name)
        start_scores = tem[:, 1]
        end_scores = tem[:, 2]

        def peaks(scores):
            bins = np.zeros(len(scores))
            bins[[0, -1]] = 1
            mx = scores.max()
            for i in range(1, tscale - 1):
                if scores[i] > scores[i + 1] and scores[i] > scores[i - 1]:
                    bins[i] = 1
                elif scores[i] > peak_threshold * mx:
                    bins[i] = 1
            return bins

        start_bins = peaks(start_scores)
        end_bins = peaks(end_scores)
        centers = tgap / 2 + tgap * np.arange(tscale)
        tmins = centers[start_bins == 1]
        tmin_scores = start_scores[start_bins == 1]
        tmaxs = centers[end_bins == 1]
        tmax_scores = end_scores[end_bins == 1]

        props = []
        for tmax, smax in zip(tmaxs, tmax_scores):
            for tmin, smin in zip(tmins, tmin_scores):
                if tmin >= tmax:
                    break
                props.append([tmin, tmax, smin, smax])
        if not props:
            proposal_dict[name] = np.zeros((0, 7), np.float32)
            continue
        props = np.asarray(props, np.float32)
        score = (props[:, 2] * props[:, 3])[:, None]
        props = np.concatenate([props, score], axis=1)
        props = props[props[:, -1].argsort()[::-1]]

        # match against gt in corrected-second units
        frame = info['duration_frame']
        second = info['duration_second']
        feat_frame = info.get('feature_frame', frame)
        corrected = float(feat_frame) / frame * second
        gt_tmins = [a['segment'][0] / corrected
                    for a in info.get('annotations', [])]
        gt_tmaxs = [a['segment'][1] / corrected
                    for a in info.get('annotations', [])]
        ious, ioas = [], []
        for p in props:
            if gt_tmins:
                ious.append(float(np.max(temporal_iou(
                    p[0], p[1], np.asarray(gt_tmins),
                    np.asarray(gt_tmaxs)))))
                ioas.append(float(np.max(temporal_iop(
                    p[0], p[1], np.asarray(gt_tmins),
                    np.asarray(gt_tmaxs)))))
            else:
                ious.append(0.0)
                ioas.append(0.0)
        props = np.concatenate(
            [props, np.asarray(ious, np.float32)[:, None],
             np.asarray(ioas, np.float32)[:, None]], axis=1)
        proposal_dict[name] = props
        if result_dict is not None:
            result_dict[name] = props
    return proposal_dict


def _region_feature(t_points, score, t0, t1, num_sample,
                    num_sample_interp):
    tlen = (t1 - t0) / (num_sample - 1)
    step = tlen / num_sample_interp
    t_new = [t0 - tlen / 2 + step * i
             for i in range(num_sample * num_sample_interp + 1)]
    y = np.interp(t_new, t_points, score)
    return [float(np.mean(y[i * num_sample_interp:
                            (i + 1) * num_sample_interp + 1]))
            for i in range(num_sample)]


def generate_bsp_feature(video_list: Sequence[int],
                         video_infos: List[Dict],
                         tem_results,
                         pgm_proposals,
                         top_k: int = 1000,
                         bsp_boundary_ratio: float = 0.2,
                         num_sample_start: int = 8,
                         num_sample_end: int = 8,
                         num_sample_action: int = 16,
                         num_sample_interp: int = 3,
                         result_dict: Optional[Dict] = None
                         ) -> Dict[str, np.ndarray]:
    """Returns {video_name: (P, start+end+action) bsp features}."""
    out = {}
    for vi in video_list:
        name = video_infos[vi]['video_name']
        tem = _load_csv_or_dict(tem_results, name)
        score_action = tem[:, 0]
        seg_tmins = tem[:, 3]
        seg_tmaxs = tem[:, 4]
        video_scale = len(tem)
        video_gap = seg_tmaxs[0] - seg_tmins[0]
        video_extend = int(video_scale / 4 + 10)
        props = _load_csv_or_dict(pgm_proposals, name)[:top_k]

        ext = np.zeros(video_extend, np.float32)
        score_ext = np.concatenate([ext, score_action, ext])
        begin_tp = [-video_gap / 2 - (video_extend - 1 - i) * video_gap
                    for i in range(video_extend)]
        middle_tp = [video_gap / 2 + i * video_gap
                     for i in range(video_scale)]
        end_tp = [video_gap / 2 + seg_tmaxs[-1] + i * video_gap
                  for i in range(video_extend)]
        t_points = begin_tp + middle_tp + end_tp

        feats = []
        for p in props:
            tmin, tmax = float(p[0]), float(p[1])
            tlen = tmax - tmin
            r = bsp_boundary_ratio
            f_start = _region_feature(
                t_points, score_ext, tmin - tlen * r, tmin + tlen * r,
                num_sample_start, num_sample_interp)
            f_end = _region_feature(
                t_points, score_ext, tmax - tlen * r, tmax + tlen * r,
                num_sample_end, num_sample_interp)
            f_action = _region_feature(
                t_points, score_ext, tmin, tmax, num_sample_action,
                num_sample_interp)
            feats.append(f_start + f_end + f_action)
        arr = np.asarray(feats, np.float32)
        out[name] = arr
        if result_dict is not None:
            result_dict[name] = arr
    return out
