"""Scale-Equalizing Pyramid Convolution in 3D (NCTHW).

Port of ``mscl_tpu/models/necks/sepc.py``: each level gets
Pconv[1](self) + Pconv[2](finer level, strided) + the trilinear-upsampled
Pconv[0](coarser level); convs init normal(0, 0.01) with zero bias.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..builder import NECKS


def trilinear_resize(x: torch.Tensor, size: Tuple[int, int, int]
                     ) -> torch.Tensor:
    """Trilinear (align_corners=False) upsampling of NCTHW to (T, H, W).

    ``jax.image.resize(method='linear')`` agrees with this only when no axis
    shrinks (it antialiases a downsample), so a shrinking size is refused.
    """
    if any(n < o for n, o in zip(size, x.shape[2:])):
        raise ValueError('trilinear_resize only upsamples: '
                         f'{tuple(x.shape[2:])} -> {tuple(size)}')
    if tuple(x.shape[2:]) == tuple(size):
        return x
    return F.interpolate(x, size=tuple(size), mode='trilinear',
                         align_corners=False)


class PConv3D(nn.Module):
    """One pyramid-conv stage: three 3x3x3 convs shared over the levels."""

    def __init__(self, in_channels: int, out_channels: int,
                 stride: Tuple[int, int, int] = (2, 1, 1)):
        super().__init__()
        self.pconv0 = nn.Conv3d(in_channels, out_channels, 3, padding=1)
        self.pconv1 = nn.Conv3d(in_channels, out_channels, 3, padding=1)
        self.pconv2 = nn.Conv3d(in_channels, out_channels, 3, stride=stride,
                                padding=1)

    def forward(self, x):
        outs = []
        for level, feature in enumerate(x):
            temp = self.pconv1(feature)
            if level > 0:
                temp = temp + self.pconv2(x[level - 1])
            if level < len(x) - 1:
                temp = temp + trilinear_resize(self.pconv0(x[level + 1]),
                                               temp.shape[2:])
            outs.append(temp)
        return [F.relu(p) for p in outs]


@NECKS.register_module()
class SEPC(nn.Module):
    """A stack of Pconv_num PConv3D stages (iBN is not ported)."""

    def __init__(self, in_channels: Sequence[int] = (256, 256, 256),
                 out_channels: int = 256, stride=(2, 1, 1), iBN: bool = False,
                 Pconv_num: int = 2):
        super().__init__()
        if iBN:
            raise NotImplementedError('SEPC iBN is not ported yet')
        self.in_channels = list(in_channels)
        self.Pconv_num = Pconv_num
        for i in range(Pconv_num):
            setattr(self, f'pconv3d_{i}', PConv3D(
                in_channels[0] if i == 0 else out_channels, out_channels,
                tuple(stride)))

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator):
        for m in self.modules():
            if isinstance(m, nn.Conv3d):
                nn.init.normal_(m.weight, 0.0, 0.01, generator=gen)
                m.bias.zero_()

    def forward(self, x):
        assert len(x) == len(self.in_channels)
        for i in range(self.Pconv_num):
            x = getattr(self, f'pconv3d_{i}')(x)
        return x
