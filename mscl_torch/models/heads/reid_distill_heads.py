"""The reid and distill heads of the MSCL ablation surface.

Port of ``mscl_tpu/models/heads/reid_distill_heads.py``:

- ``TSMReidSimpleHead`` (reference heads/reid_head.py): the TSM consensus
  (the mean over ``num_segments``), dropout, a BN-neck and the classifier;
  the pre-neck feature feeds the triplet reid loss;
- ``FGTSMReidSimpleHead``: the average-pooled stream scores, the
  max-pooled one feeds the reid loss;
- ``TSMHead3D`` (reference heads/tsm_head.py): the segments split across
  ``num_clfs`` linear classifiers whose scores are averaged;
- ``RcMoDistHead`` (reference heads/distill_head.py): each pyramid level
  predicts the frame-pair flow image through a 1x1x1 projection and a
  sigmoid, held by MSE to the pooled target.

Layouts are torch's: the 2-D heads take (N * segments, C, H, W) maps or
(N * segments, C) features (JAX: NHWC), ``RcMoDistHead`` NCTHW levels and
flow (JAX: NTHWC). ``TSMHead3D`` with a ``spatial_type`` other than 'avg'
flattens a map in JAX's (H, W, C) order, so converted weights line up.

What the JAX modules make that torch's defaults would not:

- the BN-neck is flax's ``nn.BatchNorm`` with its defaults: no bias,
  momentum 0.99 (the running statistics move by 0.01 a step, not the 0.1
  of ``ops/batch_norm.py``), the biased variance E[x^2] - E[x]^2 (at least
  0), eps 1e-5;
- the classifier of the reid heads is a raw ``fc_cls_kernel`` (in,
  classes) and ``fc_cls_bias``, not a Dense: with ``use_cosface`` the
  scores are s * (cos - m * onehot(label)) against the kernel's columns,
  the margin only while training and only when the caller passes labels,
  and the bias unused;
- ``RcMoDistHead`` makes a ``toimg_{i}`` projection (flax's Dense, to
  twice the flow's channels) a level it is given; the port builds
  ``num_levels`` of them up front, to twice ``flow_channels``, their input
  width taken at the first call (``local_align_heads.Dense``).

Dropout is ``base.SeededDropout`` (the head's own generator).
``Recognizer2D`` trains the reid heads: it passes them the labels and
hands the feature they return to their triplet loss.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from .. import compute_dtype
from ..builder import HEADS, build_loss
from .base import BaseHead, SeededDropout, topk_accuracy
from .local_align_heads import Dense


def _cosface_logits(feat, weight, s, m, labels=None, eps=1e-8):
    """Normalised-cosine logits with an additive margin on the target class
    (reference reid_head.py ``_refine_logits``); weight is (classes, in)."""
    ip = feat @ weight.T
    w1 = feat.norm(dim=1)
    w2 = weight.norm(dim=1)
    r_logits = ip / torch.outer(w1, w2).clamp(min=eps)
    if labels is None:
        return s * r_logits
    one_hot = F.one_hot(labels.long(), weight.shape[0]).to(r_logits.dtype)
    return s * (r_logits - one_hot * m)


class FlaxBatchNorm1d(nn.Module):
    """flax's ``nn.BatchNorm(use_bias=False)`` over (N, C): a scale
    (``weight``), running statistics moving by 1 - momentum (0.01) a train
    step, the biased variance E[x^2] - E[x]^2 floored at 0."""

    def __init__(self, num_features: int, momentum: float = 0.99,
                 eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.register_buffer('running_mean', torch.zeros(num_features))
        self.register_buffer('running_var', torch.ones(num_features))

    def forward(self, x):
        if self.training:
            mean = x.mean(dim=0)
            var = ((x * x).mean(dim=0) - mean * mean).clamp(min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(m).add_((1 - m) * mean.float())
                self.running_var.mul_(m).add_((1 - m) * var.float())
        else:
            mean = self.running_mean.to(x.dtype)
            var = self.running_var.to(x.dtype)
        return (x - mean) * (torch.rsqrt(var + self.eps) *
                             self.weight.to(x.dtype))


class _ReidHeadBase(SeededDropout, BaseHead):
    """The consensus over segments, the scoring (plain or cosface) and the
    loss: top-k accuracies, ``loss_cls`` and, given ``reid_feat``, the
    triplet ``loss_reid``."""

    def __init__(self, num_classes=400, in_channels=2048, loss_cls=None,
                 loss_reid=None, num_segments=8, spatial_type='avg',
                 consensus=None, dropout_ratio=0.8, init_std=0.001,
                 is_shift=True, temporal_pool=False, use_cosface=None,
                 multi_class=False, label_smooth_eps=0.0, topk=(1, 5),
                 dtype=None):
        super().__init__(num_classes, loss_cls, multi_class,
                         label_smooth_eps, topk)
        self.loss_reid = build_loss(dict(loss_reid or
                                         dict(type='TripletLoss')))
        self.num_segments = num_segments
        self.dropout_ratio = dropout_ratio
        self.init_std = init_std
        self.is_shift, self.temporal_pool = is_shift, temporal_pool
        cfg = use_cosface or dict(use=False)
        self.cosface = (cfg.get('use', False), cfg.get('s', 64),
                        cfg.get('m', 0.1))
        self.dtype = compute_dtype.resolve_dtype(dtype)
        self.fc_cls_kernel = nn.Parameter(torch.empty(in_channels,
                                                      num_classes))
        self.fc_cls_bias = nn.Parameter(torch.zeros(num_classes))

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator):
        nn.init.normal_(self.fc_cls_kernel, 0.0, self.init_std,
                        generator=gen)
        self.fc_cls_bias.zero_()

    def _segments(self) -> int:
        if self.is_shift and self.temporal_pool:
            return self.num_segments // 2
        return self.num_segments

    def _consensus(self, x):
        """(N * segments, C) -> (N, C), the mean over the segments."""
        return x.reshape((-1, self._segments()) + x.shape[1:]).mean(dim=1)

    def _score(self, feat, labels=None):
        use_cf, s, m = self.cosface
        kernel = self.fc_cls_kernel.to(feat.dtype)
        if use_cf:
            return _cosface_logits(feat, kernel.T, s, m,
                                   labels if self.training else None)
        return feat @ kernel + self.fc_cls_bias.to(feat.dtype)

    def loss(self, cls_score, labels, **kwargs) -> Dict[str, torch.Tensor]:
        feat = kwargs.pop('reid_feat', None)
        losses = {}
        if labels.dim() == 1:
            for k in self.topk:
                if k <= cls_score.shape[-1]:
                    losses[f'top{k}_acc'] = topk_accuracy(cls_score, labels,
                                                          k)
        losses['loss_cls'] = self.loss_cls(cls_score, labels)
        if feat is not None:
            losses['loss_reid'] = self.loss_reid(feat, labels)
        return losses


@HEADS.register_module()
class TSMReidSimpleHead(_ReidHeadBase):

    def __init__(self, *args, use_bnneck=True, **kwargs):
        super().__init__(*args, **kwargs)
        self.use_bnneck = use_bnneck
        if use_bnneck:
            self.bnneck = FlaxBatchNorm1d(self.fc_cls_kernel.shape[0])

    def forward(self, x, num_segs=None, labels=None, return_feat=False):
        x = x.to(self.dtype)
        if x.dim() == 4:
            x = x.mean(dim=(2, 3))
        x = self.dropout(self._consensus(x))
        feat = x                        # the pre-neck feature feeds reid
        if self.use_bnneck:
            x = self.bnneck(x)
        score = self._score(x, labels)
        return (score, feat) if return_feat else score


@HEADS.register_module()
class FGTSMReidSimpleHead(_ReidHeadBase):

    def forward(self, x, num_segs=None, labels=None, return_feat=False):
        x = x.to(self.dtype)
        x_avg = x.mean(dim=(2, 3)) if x.dim() == 4 else x
        x_mx = x.amax(dim=(2, 3)) if x.dim() == 4 else x
        x_avg = self.dropout(self._consensus(x_avg))
        x_mx = self.dropout(self._consensus(x_mx))
        score = self._score(x_avg, labels)
        return (score, x_mx) if return_feat else score


@HEADS.register_module()
class TSMHead3D(SeededDropout, BaseHead):
    """The (N * segments, C[, H, W]) input pooled ('avg') or flattened,
    dropout, then segments // num_clfs consecutive segments to each of
    ``num_clfs`` linear classifiers ``fc_cls_{i}``, their scores
    averaged."""

    def __init__(self, num_classes=400, in_channels=2048, loss_cls=None,
                 num_segments=8, num_clfs=1, spatial_type='avg',
                 dropout_ratio=0.8, init_std=0.001, is_shift=True,
                 temporal_pool=False, multi_class=False,
                 label_smooth_eps=0.0, topk=(1, 5), dtype=None):
        super().__init__(num_classes, loss_cls, multi_class,
                         label_smooth_eps, topk)
        self.num_segments, self.num_clfs = num_segments, num_clfs
        self.spatial_type = spatial_type
        self.dropout_ratio = dropout_ratio
        self.init_std = init_std
        self.dtype = compute_dtype.resolve_dtype(dtype)
        width = num_segments // num_clfs * in_channels
        for i in range(num_clfs):
            setattr(self, f'fc_cls_{i}', nn.Linear(width, num_classes))

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator):
        for i in range(self.num_clfs):
            fc = getattr(self, f'fc_cls_{i}')
            nn.init.normal_(fc.weight, 0.0, self.init_std, generator=gen)
            fc.bias.zero_()

    def forward(self, x, num_segs=None):
        if x.dim() == 4:
            if self.spatial_type == 'avg':
                x = x.mean(dim=(2, 3))
            else:
                x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        x = self.dropout(x)
        x = x.reshape(-1, self.num_clfs,
                      self.num_segments // self.num_clfs * x.shape[-1])
        scores = [compute_dtype.linear(getattr(self, f'fc_cls_{i}'),
                                       x[:, i], self.dtype)
                  for i in range(self.num_clfs)]
        return torch.stack(scores, dim=1).mean(dim=1)


def _pool_hw(v, kh, kw):
    """Mean over non-overlapping kh x kw windows of an NTHWC tensor, the
    ragged edge dropped."""
    n, t, h, w, c = v.shape
    v = v[:, :, :h // kh * kh, :w // kw * kw]
    return v.reshape(n, t, h // kh, kh, w // kw, kw, c).mean(dim=(3, 5))


@HEADS.register_module()
class RcMoDistHead(nn.Module):

    def __init__(self, basename='', loss_cls=None, num_classes=2,
                 in_channels=128, dim_fpn=128, num_levels=3,
                 flow_channels=3, dtype=None):
        super().__init__()
        self.basename = basename
        self.num_levels = num_levels
        dtype = compute_dtype.resolve_dtype(dtype)
        for i in range(num_levels):
            setattr(self, f'toimg_{i}', Dense(2 * flow_channels, dtype))

    def init_weights(self, gen: torch.Generator):
        for i in range(self.num_levels):
            getattr(self, f'toimg_{i}').init_weights(gen)

    def forward(self, q_flow_mlvl, flow_q, **kwargs):
        if len(q_flow_mlvl) != self.num_levels:
            raise ValueError(f'RcMoDistHead has {self.num_levels} levels, '
                             f'got {len(q_flow_mlvl)}')
        fq = flow_q.permute(0, 2, 3, 4, 1)            # NCTHW -> NTHWC
        n, t, h, w, c = fq.shape
        # adjacent frames paired into channels: out[..., 2c + p] =
        # flow[n, 2t + p, ..., c]
        fq = fq.reshape(n, t // 2, 2, h, w, c).permute(0, 1, 3, 4, 5, 2)
        fq = _pool_hw(fq.reshape(n, t // 2, h, w, 2 * c), 4, 4)
        rc_loss = 0.0
        for i, ft in enumerate(q_flow_mlvl):
            pred = torch.sigmoid(getattr(self, f'toimg_{i}')(
                ft.permute(0, 2, 3, 4, 1)))
            rc_loss = rc_loss + ((pred - fq) ** 2).mean()
            if i != len(q_flow_mlvl) - 1:
                fq = _pool_hw(fq, 2, 2)
        return dict(rc_loss=rc_loss)

    def loss_mx(self, rc_loss, **kwargs):
        return dict(loss_rc=rc_loss)
