"""X3D (NCTHW).

Port of ``mscl_tpu/models/backbones/x3d.py`` (reference mmaction
backbones/x3d.py): inverted bottlenecks around a depthwise 3x3x3 conv with
squeeze-excitation on every other block and swish, the widths and depths
scaled by ``gamma_w``, ``gamma_b`` and ``gamma_d``, a stem of a (1,3,3)
conv and a depthwise (5,1,1) one, and a 1x1x1 expansion (``conv5``) at the
end. The module names are the JAX tree's (``conv1_s``, ``conv1_t``,
``bn1``, ``layer{i}_{b}`` as ``layer{i}.{b}`` with ``conv1`` .. ``bn3``,
``se.fc1`` / ``se.fc2``, ``downsample`` / ``downsample_bn``, ``conv5``,
``bn5``). Inits as the JAX package's: kaiming-normal fan_out for the convs
that name it, flax's default (lecun-normal, zero bias) for the SE convs and
the downsample conv, BN 1/0. ``frozen_stages`` and ``norm_eval`` are
accepted and, as there, not applied.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .. import compute_dtype
from ..builder import BACKBONES
from ..weight_init import lecun_normal_
from .resnet3d import init_convs_bn
from .video_resnet import Conv3dNoBias, make_bn


def _round_width(width, multiplier, min_width=8, divisor=8):
    """``width`` times ``multiplier``, rounded to a multiple of ``divisor``
    (at least ``min_width``, and not under 90 % of the product)."""
    if not multiplier:
        return width
    width *= multiplier
    min_width = min_width or divisor
    new_width = max(min_width,
                    int(width + divisor / 2) // divisor * divisor)
    if new_width < 0.9 * width:
        new_width += divisor
    return int(new_width)


def _round_repeats(repeats, multiplier):
    """``repeats`` times ``multiplier``, rounded up."""
    if not multiplier:
        return repeats
    return int(math.ceil(multiplier * repeats))


class SEModule(nn.Module):
    """Squeeze-excitation: the mean over T, H, W, a 1x1x1 conv to
    ``_round_width(channels, reduction)`` (``fc1``), ReLU, one back
    (``fc2``), and the input scaled by its sigmoid."""

    def __init__(self, channels: int, reduction: float = 0.0625,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        red = _round_width(channels, reduction)
        self.fc1 = nn.Conv3d(channels, red, 1)
        self.fc2 = nn.Conv3d(red, channels, 1)
        self.dtype = dtype

    def forward(self, x):
        s = x.mean(dim=(2, 3, 4), keepdim=True)
        s = F.relu(compute_dtype.conv3d(self.fc1, s, self.dtype))
        s = compute_dtype.conv3d(self.fc2, s, self.dtype)
        return x * torch.sigmoid(s)


class BlockX3D(nn.Module):
    """1x1x1 conv-BN-ReLU to ``planes``, the depthwise 3x3x3 conv at
    (1, stride, stride), BN, SE (``se_ratio`` > 0), swish (or ReLU), a
    1x1x1 conv-BN to ``outplanes``; plus an identity or a 1x1x1
    downsample conv and its BN."""

    def __init__(self, cin: int, planes: int, outplanes: int,
                 spatial_stride: int = 1, se_ratio: float = 0.0625,
                 use_swish: bool = True, downsample: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        s = spatial_stride
        self.conv1 = Conv3dNoBias(cin, planes, 1, 1, 0, dtype)
        self.bn1 = make_bn(planes, dtype)
        self.conv2 = Conv3dNoBias(planes, planes, 3, (1, s, s), 1, dtype,
                                  groups=planes)
        self.bn2 = make_bn(planes, dtype)
        self.se = SEModule(planes, se_ratio, dtype) if se_ratio else None
        self.use_swish = use_swish
        self.conv3 = Conv3dNoBias(planes, outplanes, 1, 1, 0, dtype)
        self.bn3 = make_bn(outplanes, dtype)
        self.downsample = None
        if downsample:
            self.downsample = Conv3dNoBias(cin, outplanes, 1, (1, s, s), 0,
                                           dtype)
            self.downsample_bn = make_bn(outplanes, dtype)

    def forward(self, x):
        res = x if self.downsample is None else \
            self.downsample_bn(self.downsample(x))
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        if self.se is not None:
            y = self.se(y)
        y = y * torch.sigmoid(y) if self.use_swish else F.relu(y)
        y = self.bn3(self.conv3(y))
        return F.relu(y + res)


@BACKBONES.register_module()
class X3D(nn.Module):
    """X3D: the stem to ``_round_width(base_channels, gamma_w)``, four
    stages of ``_round_repeats(stage_blocks[i], gamma_d)`` BlockX3D (out
    widths ``_round_width(base * 2**i, 1)``, inner widths ``gamma_b`` times
    those, SE on the even blocks with se_style 'half' or on all with
    'all'), then ``conv5`` to ``gamma_b`` times the last width, BN, ReLU.
    Returns that (N, C, T, H, W) feature."""

    def __init__(self, gamma_w: float = 1.0, gamma_b: float = 2.25,
                 gamma_d: float = 2.2, pretrained=None, in_channels: int = 3,
                 base_channels: int = 24,
                 stage_blocks: Sequence[int] = (1, 2, 5, 3),
                 spatial_strides: Sequence[int] = (2, 2, 2, 2),
                 se_style: str = 'half', se_ratio: float = 0.0625,
                 use_swish: bool = True, frozen_stages: int = -1,
                 norm_eval: bool = False, dtype=None):
        super().__init__()
        dtype = compute_dtype.resolve_dtype(dtype)
        base = _round_width(base_channels, gamma_w)
        blocks = [_round_repeats(b, gamma_d) for b in stage_blocks]
        self.conv1_s = Conv3dNoBias(in_channels, base, (1, 3, 3), (1, 2, 2),
                                    (0, 1, 1), dtype)
        self.conv1_t = Conv3dNoBias(base, base, (5, 1, 1), 1, (2, 0, 0),
                                    dtype, groups=base)
        self.bn1 = make_bn(base, dtype)
        cin = base
        for i, num_blocks in enumerate(blocks):
            out = _round_width(base * 2 ** i, 1.0)
            mid = int(out * gamma_b)
            stage = []
            for b in range(num_blocks):
                use_se = se_style == 'all' or (se_style == 'half' and
                                               b % 2 == 0)
                stride = spatial_strides[i] if b == 0 else 1
                stage.append(BlockX3D(
                    cin, mid, out, stride, se_ratio if use_se else 0.0,
                    use_swish, b == 0 and (stride != 1 or cin != out),
                    dtype))
                cin = out
            setattr(self, f'layer{i + 1}', nn.Sequential(*stage))
        self.num_stages = len(blocks)
        self.conv5 = Conv3dNoBias(cin, int(cin * gamma_b), 1, 1, 0, dtype)
        self.bn5 = make_bn(int(cin * gamma_b), dtype)

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator):
        init_convs_bn(self, gen)
        for m in self.modules():
            if isinstance(m, SEModule):
                for fc in (m.fc1, m.fc2):
                    lecun_normal_(fc.weight, gen)
                    fc.bias.zero_()
            elif isinstance(m, BlockX3D) and m.downsample is not None:
                lecun_normal_(m.downsample.weight, gen)

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1_t(self.conv1_s(x))))
        for i in range(self.num_stages):
            x = getattr(self, f'layer{i + 1}')(x)
        return F.relu(self.bn5(self.conv5(x)))
