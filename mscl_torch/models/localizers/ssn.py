"""SSN, the Structured Segment Network: structured temporal pyramid
pooling (STPP) of a proposal's segments and three heads.

Port of ``mscl_tpu/models/localizers/ssn.py`` (reference mmaction
localizers/ssn.py, heads/ssn_head.py and losses/ssn_loss.py): the
backbone's frames pooled to one feature a segment, STPP over each
proposal's starting, course and ending stages, then the activity
(classes + background), completeness and class-wise regression heads;
``SSNLoss``: the activity cross entropy over the positive and background
proposals, the OHEM hinge completeness loss over the positive and
incomplete ones, and the smooth-L1 regression of the positives.

The batch is the JAX one's: ``imgs`` (B, proposals, segments, C, H, W)
from ``FormatShape('NPTCHW')``; its frames run through the port's 2D
backbone as NCHW (no transpose). Each video's proposals come in the
sampler's fixed layout [positive | incomplete | background], so the loss
slices them by count (``per_video_slice``), as the JAX one does.

As in the JAX package, ``SSN``'s own ``dropout_ratio`` is taken and never
applied (the head's is), and its backbone's ``partial_bn`` is ignored
(every BN trains). ``forward_test`` scores test proposals through the same
STPP as training, the JAX design (its proposals sampled as in training,
``SampleProposalFrames`` mode 'val'), not the reference's STPPTest.
Module names are the JAX tree's minus ``_m`` (``backbone``,
``cls_head``), so ``convert.jax_to_state_dict`` covers the model.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

from .. import compute_dtype
from ..builder import BACKBONES, HEADS, LOSSES, RECOGNIZERS
from ..heads.base import SeededDropout
from ..losses.cross_entropy_loss import cross_entropy
from ..losses.hvu_loss import ohem_hinge_loss
from .base import parse_losses_localizer


def parse_stage_config(stage_cfg):
    """An int or a tuple of part counts -> (parts, their sum)."""
    if isinstance(stage_cfg, int):
        return (stage_cfg,), stage_cfg
    parts = tuple(stage_cfg)
    return parts, sum(parts)


def stpp_train(x, scale_factors, stpp_stage=(1, (1, 2), 1),
               num_segments_list=(2, 5, 2)):
    """Structured temporal pyramid pooling (reference
    ssn_head.STPPTrain:38-126). x: (N, num_segments, C); scale_factors:
    (N, 2). Returns (course_feat (N, C), stpp_feat (N, multipliers * C))."""
    s_parts, s_mult = parse_stage_config(stpp_stage[0])
    c_parts, c_mult = parse_stage_config(stpp_stage[1])
    e_parts, e_mult = parse_stage_config(stpp_stage[2])
    num_mult = s_mult + c_mult + e_mult
    x0 = num_segments_list[0]
    x1 = x0 + num_segments_list[1]

    def stage_feats(stage_feat, parts, scale):
        out = []
        stage_len = stage_feat.shape[1]
        for part in parts:
            ticks = np.arange(0, stage_len + 1e-5,
                              stage_len / part).astype(int)
            for i in range(part):
                f = stage_feat[:, ticks[i]:ticks[i + 1]].mean(dim=1) / \
                    num_mult
                if scale is not None:
                    f = f * scale[:, None]
                out.append(f)
        return out

    feats = []
    feats += stage_feats(x[:, :x0], s_parts, scale_factors[:, 0])
    feats += stage_feats(x[:, x0:x1], c_parts, None)
    feats += stage_feats(x[:, x1:], e_parts, scale_factors[:, 1])
    return x[:, x0:x1].mean(dim=1), torch.cat(feats, dim=1)


@HEADS.register_module()
class SSNHead(SeededDropout, nn.Module):
    """reference ssn_head.SSNHead:280-360 (the training consensus)."""

    def __init__(self, dropout_ratio=0.8, in_channels=1024, num_classes=20,
                 consensus=None, use_regression=True, init_std=0.001,
                 dtype=None):
        super().__init__()
        self.dtype = compute_dtype.resolve_dtype(dtype)
        self.dropout_ratio = dropout_ratio
        self.num_classes = num_classes
        self.init_std = init_std
        cons = dict(consensus or dict(
            type='STPPTrain', stpp_stage=(1, 1, 1), num_seg=(2, 5, 2)))
        cons.pop('type', None)
        self.stpp_stage = cons.get('stpp_stage', (1, 1, 1))
        self.num_seg = tuple(cons.get('num_seg', cons.get(
            'num_segments_list', (2, 5, 2))))
        num_mult = sum(parse_stage_config(s)[1] for s in self.stpp_stage)
        self.activity_fc = nn.Linear(in_channels, num_classes + 1)
        self.completeness_fc = nn.Linear(in_channels * num_mult,
                                         num_classes)
        self.regressor_fc = nn.Linear(in_channels * num_mult,
                                      num_classes * 2) \
            if use_regression else None

    def init_weights(self, gen: torch.Generator):
        for fc in (self.activity_fc, self.completeness_fc,
                   self.regressor_fc):
            if fc is not None:
                nn.init.normal_(fc.weight, 0.0, self.init_std, generator=gen)
                nn.init.zeros_(fc.bias)

    def forward(self, x, proposal_scale_factor):
        """x: (proposals * segments, C) pooled frame features."""
        x = x.reshape(-1, sum(self.num_seg), x.shape[-1])
        scale = proposal_scale_factor.reshape(-1, 2).to(x.dtype)
        course_feat, stpp_feat = stpp_train(x, scale, self.stpp_stage,
                                            self.num_seg)
        course_feat = self.dropout(course_feat)
        stpp_feat = self.dropout(stpp_feat)
        activity = compute_dtype.linear(self.activity_fc, course_feat,
                                        self.dtype)
        completeness = compute_dtype.linear(self.completeness_fc, stpp_feat,
                                            self.dtype)
        bbox_preds = None
        if self.regressor_fc is not None:
            bbox_preds = compute_dtype.linear(
                self.regressor_fc, stpp_feat,
                self.dtype).reshape(-1, self.num_classes, 2)
        return activity, completeness, bbox_preds


@LOSSES.register_module()
class SSNLoss:
    """reference ssn_loss.py; the proposals of each video in the sampler's
    fixed [positive | incomplete | background] counts
    (``train_cfg.ssn.sampler``)."""

    def __call__(self, activity_score, completeness_score, bbox_preds,
                 proposal_type, labels, bbox_targets, train_cfg
                 ) -> Dict[str, torch.Tensor]:
        sampler = train_cfg['ssn']['sampler']
        lw = train_cfg['ssn']['loss_weight']
        total_ratio = (sampler['positive_ratio'] +
                       sampler['background_ratio'] +
                       sampler['incomplete_ratio'])
        per_video = sampler['num_per_video']
        pos = int(per_video * sampler['positive_ratio'] / total_ratio)
        bg = int(per_video * sampler['background_ratio'] / total_ratio)
        inc = per_video - pos - bg

        labels = labels.reshape(-1).long()
        n_videos = labels.shape[0] // per_video

        def per_video_slice(arr, start, count):
            return arr.reshape((n_videos, per_video) + tuple(arr.shape[1:]))[
                :, start:start + count].reshape(
                    (n_videos * count,) + tuple(arr.shape[1:]))

        # activity: the positive and the background proposals
        act_scores = torch.cat([per_video_slice(activity_score, 0, pos),
                                per_video_slice(activity_score, pos + inc,
                                                bg)])
        act_labels = torch.cat([per_video_slice(labels, 0, pos),
                                per_video_slice(labels, pos + inc, bg)])
        loss_activity = cross_entropy(act_scores, act_labels)

        # completeness: the positives (hinge +1) and the incomplete ones
        # (hinge -1, OHEM at the ratio pos / inc)
        ohem_ratio = pos / inc
        pos_pred = per_video_slice(completeness_score, 0, pos)
        inc_pred = per_video_slice(completeness_score, pos, inc)
        positive_loss = ohem_hinge_loss(
            pos_pred, per_video_slice(labels, 0, pos), 1, 1.0, pos)
        incomplete_loss = ohem_hinge_loss(
            inc_pred, per_video_slice(labels, pos, inc), -1, ohem_ratio, inc)
        num_pos = pos_pred.shape[0]
        num_inc = int(inc_pred.shape[0] * ohem_ratio)
        loss_completeness = (positive_loss + incomplete_loss) / \
            float(num_pos + num_inc)

        losses = dict(loss_activity=loss_activity,
                      loss_completeness=loss_completeness *
                      lw['comp_loss_weight'])
        if bbox_preds is not None:
            reg_pred = per_video_slice(bbox_preds, 0, pos)
            reg_labels = per_video_slice(labels, 0, pos)
            reg_targets = per_video_slice(
                bbox_targets.reshape(-1, 2).to(reg_pred.dtype), 0, pos)
            idx = torch.arange(reg_pred.shape[0], device=reg_pred.device)
            diff = reg_pred[idx, reg_labels - 1] - reg_targets
            huber = torch.where(diff.abs() < 1, 0.5 * diff ** 2,
                                diff.abs() - 0.5)
            losses['loss_reg'] = 2.0 * huber.mean() * lw['reg_loss_weight']
        return losses


@RECOGNIZERS.register_module()
class SSN(nn.Module):
    """reference ssn.py:29-135."""

    def __init__(self, backbone, cls_head, in_channels=3, spatial_type='avg',
                 dropout_ratio=0.5, loss_cls=None, train_cfg=None,
                 test_cfg=None, dtype=None):
        super().__init__()
        self.dtype = compute_dtype.resolve_dtype(dtype)
        bb_cfg = dict(backbone)
        bb_type = bb_cfg.pop('type')
        bb_cfg.pop('pretrained', None)
        self.backbone = BACKBONES.get(bb_type)(dtype=self.dtype, **bb_cfg)
        head_cfg = dict(cls_head)
        head_type = head_cfg.pop('type')
        self.cls_head = HEADS.get(head_type)(dtype=self.dtype, **head_cfg)
        loss_cfg = dict(loss_cls or dict(type='SSNLoss'))
        loss_cfg.pop('type', None)
        self._loss = SSNLoss(**loss_cfg)
        self.spatial_type = spatial_type
        self.dropout_ratio = dropout_ratio    # taken, never applied (JAX's)
        self.train_cfg = train_cfg
        self.test_cfg = test_cfg

    def init_weights(self, gen: torch.Generator):
        self.backbone.init_weights(gen)
        self.cls_head.init_weights(gen)

    # the head's dropout generator, at the model's level
    def seed_dropout(self, seed: int):
        self.cls_head.seed_dropout(seed)

    def dropout_state(self):
        return self.cls_head.dropout_state()

    def set_dropout_state(self, state) -> None:
        self.cls_head.set_dropout_state(state)

    def _pooled(self, imgs):
        """(B, P, S, C, H, W) -> (B * P * S, C') pooled frame features."""
        frames = imgs.to(self.dtype).reshape((-1,) + tuple(imgs.shape[-3:]))
        feat = self.backbone(frames)
        if isinstance(feat, (list, tuple)):
            feat = feat[-1]
        if self.spatial_type == 'avg':
            return feat.mean(dim=(2, 3))
        if self.spatial_type == 'max':
            return feat.amax(dim=(2, 3))
        return feat

    def forward_train(self, imgs, proposal_scale_factor, proposal_type,
                      proposal_labels, reg_targets) -> Dict[str, torch.Tensor]:
        activity, completeness, bbox_preds = self.cls_head(
            self._pooled(imgs), proposal_scale_factor)
        losses = self._loss(activity, completeness, bbox_preds,
                            proposal_type, proposal_labels, reg_targets,
                            dict(self.train_cfg))
        losses['loss'] = sum(losses.values())
        return losses

    def forward_test(self, imgs, proposal_scale_factor, **kwargs):
        """(activity_scores, completeness_scores, bbox_preds) of the test
        proposals, for ``SSNDataset.results_to_detections``; the caller
        sets the mode (``model.eval()``)."""
        return self.cls_head(self._pooled(imgs), proposal_scale_factor)

    def forward(self, imgs, proposal_scale_factor, return_loss=False,
                **kwargs):
        if return_loss:
            raise NotImplementedError('use train_step')
        return self.forward_test(imgs, proposal_scale_factor, **kwargs)

    def train_step(self, batch):
        losses = self.forward_train(
            batch['imgs'], batch['proposal_scale_factor'],
            batch['proposal_type'], batch['proposal_labels'],
            batch['reg_targets'])
        return parse_losses_localizer(losses)
