"""BMN, the Boundary-Matching Network's temporal proposal generator.

Port of ``mscl_tpu/models/localizers/bmn.py`` (reference mmaction
localizers/bmn.py): grouped 1D base, start and end convs; the
boundary-matching layer as one product of the proposal features with a
precomputed sample mask; a 3D conv over the samples and 2D convs giving the
(duration, start) confidence maps; ``BMNLoss``; and on the host the label
generation and the soft-NMS post-processing
(``mscl_torch/localization/proposal_utils.py``).

The batch is the JAX one's: ``raw_feature`` (B, T, feat_dim), channel last.
Inside, the features run as torch's (B, C, T): the flax 1D kernels
(k, cin / 4, cout) of the groups=4 convs are torch's (cout, cin / 4, k).
The boundary-matching product ``(B, C, T) @ (T, S * T * T)`` is plain
``torch.matmul``, as the JAX one is a plain einsum outside any kernel; it
gives (B, C, S, T_duration, T_start), torch's NCDHW with the sample axis
as D, and ``p3d``, the JAX (S, 1, 1) VALID conv over that axis, collapses
it. The confidence map is returned channel last, (B, T, T, 2), as JAX's.

The sample mask, (T, S * T * T) float32 (at the configs' T 100, S 32:
128 MB, about 99 % zeros), is built once a process for each geometry by
the JAX package's Python loop (``build_interp1d_mask``, copied; about 2 s
on a host core at full size) and kept as a buffer on the module's device,
outside the state dict. The proposal loss's balanced sample draws from the
model's generator (``SeededDropout``'s: seeded by ``seed_dropout``, saved
in checkpoints as ``dropout_state``).
"""
from __future__ import annotations

import functools
import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import compute_dtype
from ...localization.proposal_utils import (post_processing, temporal_iop,
                                            temporal_iou)
from ..builder import RECOGNIZERS, build_loss
from ..heads.base import SeededDropout
from ..weight_init import lecun_normal_
from .base import parse_losses_localizer, to_numpy


def _interp1d_bin_mask(seg_tmin, seg_tmax, tscale, num_samples,
                       num_samples_per_bin):
    """(reference bmn.py:358-381)."""
    plen = float(seg_tmax - seg_tmin)
    plen_sample = plen / (num_samples * num_samples_per_bin - 1.0)
    total_samples = [seg_tmin + plen_sample * i
                     for i in range(num_samples * num_samples_per_bin)]
    p_mask = []
    for idx in range(num_samples):
        bin_samples = total_samples[idx * num_samples_per_bin:
                                    (idx + 1) * num_samples_per_bin]
        bin_vector = np.zeros(tscale)
        for sample in bin_samples:
            sample_upper = math.ceil(sample)
            sample_decimal, sample_down = math.modf(sample)
            if 0 <= int(sample_down) <= (tscale - 1):
                bin_vector[int(sample_down)] += 1 - sample_decimal
            if 0 <= int(sample_upper) <= (tscale - 1):
                bin_vector[int(sample_upper)] += sample_decimal
        p_mask.append(bin_vector / num_samples_per_bin)
    return np.stack(p_mask, axis=1)


@functools.lru_cache(maxsize=4)
def build_interp1d_mask(tscale, num_samples, num_samples_per_bin,
                        boundary_ratio):
    """(tscale, num_samples * tscale * tscale) float32 sample mask, its
    columns in (sample, duration, start) order (reference bmn.py:383-405);
    built once a process for each geometry (read-only)."""
    mask_mat = []
    for start_index in range(tscale):
        mask_mat_vector = []
        for duration_index in range(tscale):
            if start_index + duration_index < tscale:
                p_tmin = start_index
                p_tmax = start_index + duration_index
                center_len = float(p_tmax - p_tmin) + 1
                sample_tmin = p_tmin - center_len * boundary_ratio
                sample_tmax = p_tmax + center_len * boundary_ratio
                p_mask = _interp1d_bin_mask(
                    sample_tmin, sample_tmax, tscale, num_samples,
                    num_samples_per_bin)
            else:
                p_mask = np.zeros([tscale, num_samples])
            mask_mat_vector.append(p_mask)
        mask_mat.append(np.stack(mask_mat_vector, axis=2))
    mask = np.stack(mask_mat, axis=3).astype(np.float32)
    mask = mask.reshape(tscale, -1)
    mask.flags.writeable = False
    return mask


def build_match_map(tscale):
    temporal_gap = 1.0 / tscale
    match_map = []
    for idx in range(tscale):
        match_window = []
        tmin = temporal_gap * idx
        for jdx in range(1, tscale + 1):
            match_window.append([tmin, tmin + temporal_gap * jdx])
        match_map.append(match_window)
    match_map = np.transpose(np.array(match_map), [1, 0, 2])
    return match_map.reshape(-1, 2)


def _conv1d(cin, cout, kernel, groups=1):
    return nn.Conv1d(cin, cout, kernel, padding=kernel // 2, groups=groups)


@RECOGNIZERS.register_module()
class BMN(SeededDropout, nn.Module):

    def __init__(self, temporal_dim=100, boundary_ratio=0.5, num_samples=32,
                 num_samples_per_bin=3, feat_dim=400, soft_nms_alpha=0.4,
                 soft_nms_low_threshold=0.5, soft_nms_high_threshold=0.9,
                 post_process_top_k=100, feature_extraction_interval=16,
                 loss_cls=None, hidden_dim_1d=256, hidden_dim_2d=128,
                 hidden_dim_3d=512, train_cfg=None, test_cfg=None,
                 dtype=None):
        super().__init__()
        self.dtype = compute_dtype.resolve_dtype(dtype)
        self.temporal_dim = temporal_dim
        self.boundary_ratio = boundary_ratio
        self.num_samples = num_samples
        self.num_samples_per_bin = num_samples_per_bin
        self.soft_nms_alpha = soft_nms_alpha
        self.soft_nms_low_threshold = soft_nms_low_threshold
        self.soft_nms_high_threshold = soft_nms_high_threshold
        self.post_process_top_k = post_process_top_k
        self.feature_extraction_interval = feature_extraction_interval
        self.train_cfg, self.test_cfg = train_cfg, test_cfg
        h = hidden_dim_1d
        self.b1 = _conv1d(feat_dim, h, 3, 4)
        self.b2 = _conv1d(h, h, 3, 4)
        self.s1 = _conv1d(h, h, 3, 4)
        self.s2 = _conv1d(h, 1, 1)
        self.e1 = _conv1d(h, h, 3, 4)
        self.e2 = _conv1d(h, 1, 1)
        self.p1 = _conv1d(h, h, 3, 4)
        self.p3d = nn.Conv3d(h, hidden_dim_3d, (num_samples, 1, 1))
        self.p2d_1 = nn.Conv2d(hidden_dim_3d, hidden_dim_2d, 1)
        self.p2d_2 = nn.Conv2d(hidden_dim_2d, hidden_dim_2d, 3, padding=1)
        self.p2d_3 = nn.Conv2d(hidden_dim_2d, hidden_dim_2d, 3, padding=1)
        self.p2d_4 = nn.Conv2d(hidden_dim_2d, 2, 1)
        t = temporal_dim
        self.register_buffer('bm_mask', torch.tensor(
            [[1.0] * (t - i) + [0.0] * i for i in range(t)]),
            persistent=False)
        self.register_buffer('sample_mask', torch.empty(0),
                             persistent=False)
        self._loss = build_loss(dict(loss_cls or dict(type='BMNLoss')))

    def init_weights(self, gen: torch.Generator):
        """flax's default init: lecun-normal kernels, zero biases."""
        for m in self.modules():
            if isinstance(m, nn.modules.conv._ConvNd):
                lecun_normal_(m.weight, gen)
                nn.init.zeros_(m.bias)

    def _sample_mask(self, device) -> torch.Tensor:
        """The sample mask on ``device``, made there at first use (not on
        the meta device)."""
        if self.sample_mask.numel() == 0 or self.sample_mask.device != device:
            self.sample_mask = torch.tensor(build_interp1d_mask(
                self.temporal_dim, self.num_samples,
                self.num_samples_per_bin, self.boundary_ratio),
                device=device)
        return self.sample_mask

    def _conv(self, layer, x):
        return compute_dtype.conv(layer, x, self.dtype)

    def _forward(self, raw_feature):
        """(B, T, feat_dim) -> (confidence (B, T, T, 2), start (B, T), end
        (B, T))."""
        x = raw_feature.to(self.dtype).transpose(1, 2)    # (B, C, T)
        base = F.relu(self._conv(self.b1, x))
        base = F.relu(self._conv(self.b2, base))
        start = F.relu(self._conv(self.s1, base))
        start = torch.sigmoid(self._conv(self.s2, start))
        end = F.relu(self._conv(self.e1, base))
        end = torch.sigmoid(self._conv(self.e2, end))
        conf = F.relu(self._conv(self.p1, base))
        b, c, t = conf.shape
        bm = torch.matmul(conf, self._sample_mask(conf.device).to(conf.dtype))
        bm = bm.reshape(b, c, self.num_samples, t, t)
        bm = F.relu(self._conv(self.p3d, bm)).squeeze(2)   # (B, C3, T, T)
        bm = F.relu(self._conv(self.p2d_1, bm))
        bm = F.relu(self._conv(self.p2d_2, bm))
        bm = F.relu(self._conv(self.p2d_3, bm))
        bm = torch.sigmoid(self._conv(self.p2d_4, bm))
        return bm.permute(0, 2, 3, 1), start[:, 0], end[:, 0]

    def forward_train(self, raw_feature, label_confidence, label_start,
                      label_end) -> Dict[str, torch.Tensor]:
        conf, start, end = self._forward(raw_feature)
        total, tem, pem_reg, pem_cls = self._loss(
            conf, start, end, label_confidence, label_start, label_end,
            self.bm_mask.to(conf.dtype),
            self.dropout_generator(conf.device))
        return dict(loss=total, loss_tem=tem, loss_pem_reg=pem_reg,
                    loss_pem_cls=pem_cls)

    def forward_test(self, raw_feature):
        return self._forward(raw_feature)

    def forward(self, raw_feature, return_loss: bool = False, **labels):
        if return_loss:
            return self.forward_train(raw_feature, **labels)
        return self.forward_test(raw_feature)

    def train_step(self, batch):
        losses = self.forward_train(
            batch['raw_feature'], batch['label_confidence'],
            batch['label_start'], batch['label_end'])
        return parse_losses_localizer(losses)

    # ------------------------------------------------- host-side helpers
    def generate_labels(self, gt_bbox):
        """Host numpy label generation (reference bmn.py:285-338)."""
        match_map = build_match_map(self.temporal_dim)
        tgap = 1.0 / self.temporal_dim
        anchors_tmins = np.arange(self.temporal_dim) * tgap
        anchors_tmaxs = anchors_tmins + tgap
        conf_list, start_list, end_list = [], [], []
        for every_gt_bbox in gt_bbox:
            every_gt_bbox = np.asarray(to_numpy(every_gt_bbox), np.float32)
            gt_iou_map = np.max(np.stack([
                temporal_iou(match_map[:, 0], match_map[:, 1], s, e)
                .reshape(self.temporal_dim, self.temporal_dim)
                for s, e in every_gt_bbox]), axis=0)
            gt_tmins = every_gt_bbox[:, 0]
            gt_tmaxs = every_gt_bbox[:, 1]
            pad = 3 * tgap
            starts = np.stack([gt_tmins - pad / 2, gt_tmins + pad / 2],
                              axis=1)
            ends = np.stack([gt_tmaxs - pad / 2, gt_tmaxs + pad / 2],
                            axis=1)
            ms = [np.max(temporal_iop(tmin, tmax, starts[:, 0],
                                      starts[:, 1]))
                  for tmin, tmax in zip(anchors_tmins, anchors_tmaxs)]
            me = [np.max(temporal_iop(tmin, tmax, ends[:, 0],
                                      ends[:, 1]))
                  for tmin, tmax in zip(anchors_tmins, anchors_tmaxs)]
            conf_list.append(gt_iou_map.astype(np.float32))
            start_list.append(np.array(ms, np.float32))
            end_list.append(np.array(me, np.float32))
        return (np.stack(conf_list), np.stack(start_list),
                np.stack(end_list))

    def proposals_from_outputs(self, conf, start, end, video_info):
        """Host post-processing for one video (reference
        bmn.py:215-284): ``conf`` (T, T, 2), ``start`` and ``end`` (T,)."""
        start_scores = to_numpy(start)
        end_scores = to_numpy(end)
        conf = to_numpy(conf)
        reg_conf = conf[..., 0]
        cls_conf = conf[..., 1]
        tscale = self.temporal_dim
        max_start, max_end = start_scores.max(), end_scores.max()
        start_bins = np.zeros(tscale)
        end_bins = np.zeros(tscale)
        start_bins[0] = 1
        end_bins[-1] = 1
        for idx in range(1, tscale - 1):
            if start_scores[idx] > start_scores[idx + 1] and \
                    start_scores[idx] > start_scores[idx - 1]:
                start_bins[idx] = 1
            elif start_scores[idx] > 0.5 * max_start:
                start_bins[idx] = 1
            if end_scores[idx] > end_scores[idx + 1] and \
                    end_scores[idx] > end_scores[idx - 1]:
                end_bins[idx] = 1
            elif end_scores[idx] > 0.5 * max_end:
                end_bins[idx] = 1
        new_proposals = []
        for idx in range(tscale):
            for jdx in range(tscale):
                start_index = jdx
                end_index = start_index + idx + 1
                if end_index < tscale and start_bins[start_index] == 1 \
                        and end_bins[end_index] == 1:
                    tmin = start_index / tscale
                    tmax = end_index / tscale
                    score = (start_scores[start_index] *
                             end_scores[end_index] *
                             cls_conf[idx, jdx] * reg_conf[idx, jdx])
                    new_proposals.append([
                        tmin, tmax, start_scores[start_index],
                        end_scores[end_index], cls_conf[idx, jdx],
                        reg_conf[idx, jdx], score])
        if not new_proposals:
            return []
        return post_processing(
            np.stack(new_proposals), video_info, self.soft_nms_alpha,
            self.soft_nms_low_threshold, self.soft_nms_high_threshold,
            self.post_process_top_k, self.feature_extraction_interval)
