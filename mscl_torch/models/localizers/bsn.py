"""BSN, the Boundary Sensitive Network: TEM and PEM.

Port of ``mscl_tpu/models/localizers/bsn.py`` (reference mmaction
localizers/bsn.py):

- ``TEM``: three 1D convs giving the sigmoid action, start and end curves
  of a video's features, each held by the class-balanced logistic loss;
  the host's IoP label generation.
- ``PEM``: a two-layer MLP scoring each proposal's boundary-sensitive
  features, trained by a smooth-L1 IoU regression over a balanced random
  sample of the proposals; the host's soft-NMS post-processing.

The batches are the JAX ones': ``raw_feature`` (B, T, C) channel last,
``bsp_feature`` (B, P, F); the flax 1D kernels (k, cin, cout) are torch's
(cout, cin, k), the Dense kernels transposed. PEM's balanced sample draws
from the model's generator (``SeededDropout``'s, as BMN's), not from JAX's
key.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import compute_dtype
from ...localization.proposal_utils import post_processing, temporal_iop
from ..builder import RECOGNIZERS, build_loss
from ..heads.base import SeededDropout
from ..losses.bmn_loss import draw_uniforms
from ..weight_init import lecun_normal_
from .base import parse_losses_localizer, to_numpy


def _default_init(module: nn.Module, gen: torch.Generator):
    """flax's default init: lecun-normal kernels, zero biases."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.modules.conv._ConvNd)):
            lecun_normal_(m.weight, gen)
            nn.init.zeros_(m.bias)


@RECOGNIZERS.register_module()
class TEM(nn.Module):

    def __init__(self, temporal_dim=100, boundary_ratio=0.1,
                 tem_feat_dim=400, tem_hidden_dim=512,
                 tem_match_threshold=0.5, loss_cls=None, loss_weight=2.0,
                 output_dim=3, conv1_ratio=1.0, conv2_ratio=1.0,
                 conv3_ratio=0.01, train_cfg=None, test_cfg=None,
                 dtype=None):
        super().__init__()
        self.dtype = compute_dtype.resolve_dtype(dtype)
        self.temporal_dim = temporal_dim
        self.boundary_ratio = boundary_ratio
        self.tem_match_threshold = tem_match_threshold
        self.loss_weight = loss_weight
        self.conv1_ratio, self.conv2_ratio, self.conv3_ratio = \
            conv1_ratio, conv2_ratio, conv3_ratio
        self.train_cfg, self.test_cfg = train_cfg, test_cfg
        self.conv1 = nn.Conv1d(tem_feat_dim, tem_hidden_dim, 3, padding=1)
        self.conv2 = nn.Conv1d(tem_hidden_dim, tem_hidden_dim, 3, padding=1)
        self.conv3 = nn.Conv1d(tem_hidden_dim, output_dim, 1)
        self._loss = build_loss(dict(
            loss_cls or dict(type='BinaryLogisticRegressionLoss')))

    def init_weights(self, gen: torch.Generator):
        _default_init(self, gen)

    def _anchors(self):
        tgap = 1.0 / self.temporal_dim
        tmins = np.arange(self.temporal_dim) * tgap
        return tmins, tmins + tgap

    def _forward(self, raw_feature):
        """(B, T, C) -> (B, T, output_dim)."""
        x = raw_feature.to(self.dtype).transpose(1, 2)
        x = F.relu(self.conv1_ratio *
                   compute_dtype.conv(self.conv1, x, self.dtype))
        x = F.relu(self.conv2_ratio *
                   compute_dtype.conv(self.conv2, x, self.dtype))
        x = torch.sigmoid(self.conv3_ratio *
                          compute_dtype.conv(self.conv3, x, self.dtype))
        return x.transpose(1, 2)

    def forward_train(self, raw_feature, label_action, label_start,
                      label_end) -> Dict[str, torch.Tensor]:
        out = self._forward(raw_feature)
        loss_action = self._loss(out[..., 0], label_action,
                                 self.tem_match_threshold)
        loss_start = self._loss(out[..., 1], label_start,
                                self.tem_match_threshold)
        loss_end = self._loss(out[..., 2], label_end,
                              self.tem_match_threshold)
        total = loss_action * self.loss_weight + loss_start + loss_end
        return dict(loss=total,
                    loss_action=loss_action * self.loss_weight,
                    loss_start=loss_start, loss_end=loss_end)

    def forward_test(self, raw_feature):
        return self._forward(raw_feature)

    def forward(self, raw_feature, return_loss: bool = False, **labels):
        if return_loss:
            return self.forward_train(raw_feature, **labels)
        return self.forward_test(raw_feature)

    def train_step(self, batch):
        losses = self.forward_train(
            batch['raw_feature'], batch['label_action'],
            batch['label_start'], batch['label_end'])
        return parse_losses_localizer(losses)

    def generate_labels(self, gt_bbox):
        """Host label generation (reference bsn.py:163-207)."""
        a_list, s_list, e_list = [], [], []
        for every_gt_bbox in gt_bbox:
            every_gt_bbox = np.asarray(to_numpy(every_gt_bbox), np.float32)
            gt_tmins = every_gt_bbox[:, 0]
            gt_tmaxs = every_gt_bbox[:, 1]
            gt_lens = gt_tmaxs - gt_tmins
            pad = np.maximum(1.0 / self.temporal_dim,
                             self.boundary_ratio * gt_lens)
            starts = np.stack([gt_tmins - pad / 2, gt_tmins + pad / 2], 1)
            ends = np.stack([gt_tmaxs - pad / 2, gt_tmaxs + pad / 2], 1)
            ma, ms, me = [], [], []
            anchors_tmins, anchors_tmaxs = self._anchors()
            for tmin, tmax in zip(anchors_tmins, anchors_tmaxs):
                ma.append(np.max(temporal_iop(tmin, tmax, gt_tmins,
                                              gt_tmaxs)))
                ms.append(np.max(temporal_iop(tmin, tmax, starts[:, 0],
                                              starts[:, 1])))
                me.append(np.max(temporal_iop(tmin, tmax, ends[:, 0],
                                              ends[:, 1])))
            a_list.append(ma)
            s_list.append(ms)
            e_list.append(me)
        return (np.array(a_list, np.float32),
                np.array(s_list, np.float32),
                np.array(e_list, np.float32))


@RECOGNIZERS.register_module()
class PEM(SeededDropout, nn.Module):

    def __init__(self, pem_feat_dim=32, pem_hidden_dim=256,
                 pem_u_ratio_m=1.0, pem_u_ratio_l=2.0,
                 pem_high_temporal_iou_threshold=0.6,
                 pem_low_temporal_iou_threshold=0.2, soft_nms_alpha=0.75,
                 soft_nms_low_threshold=0.65, soft_nms_high_threshold=0.9,
                 post_process_top_k=100, feature_extraction_interval=16,
                 fc1_ratio=0.1, fc2_ratio=0.1, output_dim=1,
                 train_cfg=None, test_cfg=None, dtype=None):
        super().__init__()
        self.dtype = compute_dtype.resolve_dtype(dtype)
        self.pem_u_ratio_m = pem_u_ratio_m
        self.pem_u_ratio_l = pem_u_ratio_l
        self.pem_high_temporal_iou_threshold = \
            pem_high_temporal_iou_threshold
        self.pem_low_temporal_iou_threshold = pem_low_temporal_iou_threshold
        self.soft_nms_alpha = soft_nms_alpha
        self.soft_nms_low_threshold = soft_nms_low_threshold
        self.soft_nms_high_threshold = soft_nms_high_threshold
        self.post_process_top_k = post_process_top_k
        self.feature_extraction_interval = feature_extraction_interval
        self.fc1_ratio, self.fc2_ratio = fc1_ratio, fc2_ratio
        self.train_cfg, self.test_cfg = train_cfg, test_cfg
        self.fc1 = nn.Linear(pem_feat_dim, pem_hidden_dim)
        self.fc2 = nn.Linear(pem_hidden_dim, output_dim)

    def init_weights(self, gen: torch.Generator):
        _default_init(self, gen)

    def _forward(self, x):
        x = F.relu(self.fc1_ratio * compute_dtype.linear(
            self.fc1, x.to(self.dtype), self.dtype))
        return torch.sigmoid(self.fc2_ratio * compute_dtype.linear(
            self.fc2, x, self.dtype))

    def forward_train(self, bsp_feature, reference_temporal_iou
                      ) -> Dict[str, torch.Tensor]:
        pred = self._forward(bsp_feature).reshape(-1)
        ref = reference_temporal_iou.reshape(-1).to(pred.dtype)
        dt = pred.dtype
        high = self.pem_high_temporal_iou_threshold
        low = self.pem_low_temporal_iou_threshold
        u_hmask = (ref > high).to(dt)
        u_mmask = ((ref <= high) & (ref > low)).to(dt)
        u_lmask = (ref <= low).to(dt)
        num_h = u_hmask.sum()
        num_m = u_mmask.sum().clamp(min=1.0)
        num_l = u_lmask.sum().clamp(min=1.0)
        u1, u2 = (u.to(dt) for u in draw_uniforms(
            self.dropout_generator(ref.device), ref.shape, ref.device))
        r_m = (self.pem_u_ratio_m * num_h / num_m).clamp(max=1.0)
        u_smmask = (u1 * u_mmask > (1.0 - r_m)).to(dt)
        r_l = (self.pem_u_ratio_l * num_h / num_l).clamp(max=1.0)
        u_slmask = (u2 * u_lmask > (1.0 - r_l)).to(dt)
        weights = u_hmask + u_smmask + u_slmask
        diff = pred - ref
        huber = torch.where(diff.abs() < 1, 0.5 * diff ** 2,
                            diff.abs() - 0.5)
        loss = (huber * weights).sum() / weights.sum().clamp(min=1.0)
        return dict(loss=loss, temporal_iou_loss=loss)

    def forward_test(self, bsp_feature):
        return self._forward(bsp_feature).reshape(-1)

    def forward(self, bsp_feature, reference_temporal_iou=None,
                return_loss: bool = False):
        if return_loss:
            return self.forward_train(bsp_feature, reference_temporal_iou)
        return self.forward_test(bsp_feature)

    def train_step(self, batch):
        losses = self.forward_train(batch['bsp_feature'],
                                    batch['reference_temporal_iou'])
        return parse_losses_localizer(losses)

    def proposals_from_outputs(self, pem_scores, tmin, tmax, tmin_score,
                               tmax_score, video_info):
        """Host post-processing (reference bsn.py:353-380)."""
        pem_scores = to_numpy(pem_scores).reshape(-1, 1)
        tmin = to_numpy(tmin).reshape(-1, 1)
        tmax = to_numpy(tmax).reshape(-1, 1)
        tmin_score = to_numpy(tmin_score).reshape(-1, 1)
        tmax_score = to_numpy(tmax_score).reshape(-1, 1)
        score = pem_scores * tmin_score * tmax_score
        result = np.concatenate(
            (tmin, tmax, tmin_score, tmax_score, pem_scores, score),
            axis=1)
        return post_processing(result, video_info, self.soft_nms_alpha,
                               self.soft_nms_low_threshold,
                               self.soft_nms_high_threshold,
                               self.post_process_top_k,
                               self.feature_extraction_interval)
