"""TPN, the two-flow Temporal Pyramid Network neck (NCTHW).

Port of ``mscl_tpu/models/necks/tpn.py`` (reference mmaction
necks/tpn.py): the last ``len(in_channels)`` backbone stages brought to
the top stage's width and resolution by strided (1,3,3) ConvBN-ReLUs
(``spatial_{i}_{j}``), a ``TemporalModulation`` a level to
``out_channels`` (``tm_{i}``), the top-down flow (each coarser level
repeated in time onto the finer and added) and its ``LevelFusion``
(``level_fusion_td``), the bottom-up flow (a (3,1,1) conv,
``downsample_op_{i}``, then a temporal max-pool at the rate difference,
added to the coarser level) and its fusion (``level_fusion_bu``), and a
1x1x1 ConvBN-ReLU of both to the top stage's width (``pyramid_fusion``).

With ``aux_head_cfg`` and labels (training), the auxiliary head on the
backbone's penultimate stage: a (1,3,3) conv at (1,2,2) to twice its
channels (``aux_conv``), BN (``aux_bn``), the mean over T, H, W, dropout
0.5, ``aux_fc`` to ``aux_head_cfg['num_classes']`` (400 unless given: the
JAX module reads no ``out_channels``, ROADMAP.md Queue 3) and
``loss_weight`` (0.5) times its loss, ``loss_aux``. The dropout is fixed,
as in the JAX module (no config turns it off), and draws its mask from the
neck's own generator (``SeededDropout``), so its bits are not JAX's.

Module names are the JAX tree's, each ConvBN-ReLU ``conv`` / ``bn``; the
init is the JAX package's: xavier-uniform conv kernels, BN 1/0, ``aux_fc``
normal(0.01) with a zero bias. Returns (the fused feature, the auxiliary
losses).
"""
from __future__ import annotations

import math
from typing import Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .. import compute_dtype
from ..backbones.video_resnet import make_bn
from ..builder import NECKS, build_loss
from ..heads.base import SeededDropout
from ...ops.batch_norm import BatchNorm3d
from .fpn_video import TemporalModulation


class _ConvBnRelu3d(nn.Module):
    """A bias-free (grouped) Conv3d, BN, ReLU."""

    def __init__(self, cin: int, cout: int, kernel=(1, 1, 1),
                 stride=(1, 1, 1), padding=(0, 0, 0), groups: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv = nn.Conv3d(cin, cout, kernel, stride, padding,
                              groups=groups, bias=False)
        self.bn = make_bn(cout, dtype)

    def forward(self, x):
        return F.relu(self.bn(compute_dtype.conv3d(self.conv, x, self.dtype)))


class LevelFusion(nn.Module):
    """Each level through a grouped (32) 1x1x1 ConvBN-ReLU to its
    ``mid_channels`` (``downsample_{i}``), concatenated, then a 1x1x1
    ConvBN-ReLU to ``out_channels`` (``fusion``)."""

    def __init__(self, in_channels: Sequence[int], mid_channels: Sequence[int],
                 out_channels: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        for i, (cin, mid) in enumerate(zip(in_channels, mid_channels)):
            setattr(self, f'downsample_{i}', _ConvBnRelu3d(
                cin, mid, groups=32, dtype=dtype))
        self.num = len(in_channels)
        self.fusion = _ConvBnRelu3d(sum(mid_channels), out_channels,
                                    dtype=dtype)

    def forward(self, inputs):
        return self.fusion(torch.cat(
            [getattr(self, f'downsample_{i}')(x)
             for i, x in enumerate(inputs)], dim=1))


@NECKS.register_module()
class TPN(SeededDropout, nn.Module):
    """The TPN neck (see the module's docstring). ``spatial_modulation_cfg``,
    ``downsample_cfg`` and ``level_fusion_cfg`` are accepted and, as in
    the JAX module, not read: their shipped values are this geometry;
    ``upsample_cfg`` or ``flow_type='cascade'`` turns the top-down flow
    on."""
    dropout_ratio = 0.5

    def __init__(self, in_channels: Sequence[int] = (1024, 2048),
                 out_channels: int = 1024, spatial_modulation_cfg=None,
                 temporal_modulation_cfg=None, upsample_cfg=None,
                 downsample_cfg=None, level_fusion_cfg=None,
                 aux_head_cfg=None, flow_type: str = 'cascade', dtype=None):
        super().__init__()
        self.dtype = dtype = compute_dtype.resolve_dtype(dtype)
        in_channels = list(in_channels)
        self.num = num = len(in_channels)
        top = in_channels[-1]
        self.num_convs = []
        for i, cin in enumerate(in_channels):
            factor = top // cin
            n = int(math.log2(factor)) if factor > 1 else 0
            for j in range(n):
                c = cin * 2 ** (j + 1)
                setattr(self, f'spatial_{i}_{j}', _ConvBnRelu3d(
                    c // 2, c, (1, 3, 3), (1, 2, 2), (0, 1, 1), dtype=dtype))
            self.num_convs.append(n)
        tm_cfg = temporal_modulation_cfg or dict(downsample_scales=(8, 8))
        for i, s in enumerate(tm_cfg['downsample_scales'][:num]):
            setattr(self, f'tm_{i}', TemporalModulation(
                out_channels, s, dtype,
                in_channels=in_channels[i] * 2 ** self.num_convs[i]))
        self.top_down = upsample_cfg is not None or flow_type == 'cascade'
        mids = (out_channels,) * num
        self.level_fusion_td = LevelFusion(mids, mids, out_channels * 2,
                                           dtype)
        for i in range(num - 1):
            setattr(self, f'downsample_op_{i}', nn.Conv3d(
                out_channels, out_channels, (3, 1, 1), padding=(1, 0, 0),
                bias=False))
        self.level_fusion_bu = LevelFusion(mids, mids, out_channels * 2,
                                           dtype)
        self.pyramid_fusion = _ConvBnRelu3d(out_channels * 4, top,
                                            dtype=dtype)
        self.aux_head_cfg = None
        if aux_head_cfg is not None:
            cfg = self.aux_head_cfg = dict(aux_head_cfg)
            c = in_channels[-2]
            self.aux_conv = nn.Conv3d(c, 2 * c, (1, 3, 3), (1, 2, 2),
                                      (0, 1, 1), bias=False)
            self.aux_bn = make_bn(2 * c, dtype)
            self.aux_fc = nn.Linear(2 * c, cfg.get('num_classes', 400))
            self.aux_loss = build_loss(dict(
                cfg.get('loss_cls') or dict(type='CrossEntropyLoss')))
            self.aux_weight = cfg.get('loss_weight', 0.5)

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator):
        for m in self.modules():
            if isinstance(m, nn.Conv3d):
                nn.init.xavier_uniform_(m.weight, generator=gen)
            elif isinstance(m, BatchNorm3d):
                m.weight.fill_(1.0)
                m.bias.zero_()
        if self.aux_head_cfg is not None:
            nn.init.normal_(self.aux_fc.weight, 0.0, 0.01, generator=gen)
            self.aux_fc.bias.zero_()

    def _conv(self, layer, x):
        return compute_dtype.conv3d(layer, x, self.dtype)

    def forward(self, x, labels=None):
        """x: the backbone's stages; the last ``len(in_channels)`` feed the
        pyramid. Returns (the fused feature, {'loss_aux': ...} in training
        with labels and an aux head, else {})."""
        feats = list(x[-self.num:])
        pyramid = []
        for i, f in enumerate(feats):
            for j in range(self.num_convs[i]):
                f = getattr(self, f'spatial_{i}_{j}')(f)
            pyramid.append(getattr(self, f'tm_{i}')(f))
        if self.top_down:
            for i in range(self.num - 1, 0, -1):
                up = pyramid[i]
                rate = pyramid[i - 1].shape[2] // up.shape[2] \
                    if up.shape[2] else 0
                if rate > 1:
                    up = up.repeat_interleave(rate, dim=2)
                pyramid[i - 1] = pyramid[i - 1] + up
        td = self.level_fusion_td(pyramid)
        for i in range(self.num - 1):
            down = self._conv(getattr(self, f'downsample_op_{i}'),
                              pyramid[i])
            rate = down.shape[2] // pyramid[i + 1].shape[2] \
                if pyramid[i + 1].shape[2] else 0
            if rate > 1:
                n, c, t, h, w = down.shape
                down = down.reshape(n, c, t // rate, rate, h, w).amax(dim=3)
            pyramid[i + 1] = pyramid[i + 1] + down
        bu = self.level_fusion_bu(pyramid)
        out = self.pyramid_fusion(torch.cat([td, bu], dim=1))
        losses: Dict[str, torch.Tensor] = {}
        if self.aux_head_cfg is not None and labels is not None:
            feat = self.aux_bn(self._conv(self.aux_conv, x[-2]))
            feat = self.dropout(feat.mean(dim=(2, 3, 4)))
            score = compute_dtype.linear(self.aux_fc, feat, self.dtype)
            losses['loss_aux'] = self.aux_weight * self.aux_loss(
                score, labels.reshape(-1))
        return out, losses
