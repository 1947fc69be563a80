"""3D Feature Pyramid Network (NCTHW).

Port of ``mscl_tpu/models/necks/fpn.py``: lateral 1x1x1 convs, a top-down
pathway with nearest upsampling, per-level (1,3,3) convs. The JAX package's
``torch_nearest_resize`` reproduces ``F.interpolate(mode='nearest')``, which
is used here directly.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..builder import NECKS


def torch_nearest_resize(x: torch.Tensor, size: Tuple[int, int, int]
                         ) -> torch.Tensor:
    """Nearest resize of NCTHW to (T, H, W): src = floor(dst * in / out)."""
    if tuple(x.shape[2:]) == tuple(size):
        return x
    return F.interpolate(x, size=tuple(size), mode='nearest')


@NECKS.register_module()
class FPN(nn.Module):

    def __init__(self, in_channels: Sequence[int], out_channels: int,
                 fpn_kerne_size=(1, 3, 3)):  # the reference's spelling
        super().__init__()
        ks = fpn_kerne_size
        ks = (ks,) * 3 if isinstance(ks, int) else tuple(ks)
        pad = tuple((k - 1) // 2 for k in ks)
        self.levels = len(in_channels)
        for i, cin in enumerate(in_channels):
            setattr(self, f'lateral_{i}', nn.Conv3d(cin, out_channels, 1))
            setattr(self, f'fpn_{i}', nn.Conv3d(out_channels, out_channels,
                                                ks, padding=pad))

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator):
        for m in self.modules():
            if isinstance(m, nn.Conv3d):
                nn.init.xavier_uniform_(m.weight, generator=gen)
                m.bias.zero_()

    def forward(self, inputs):
        assert len(inputs) == self.levels
        laterals = [getattr(self, f'lateral_{i}')(x)
                    for i, x in enumerate(inputs)]
        for i in range(self.levels - 1, 0, -1):
            laterals[i - 1] = laterals[i - 1] + torch_nearest_resize(
                laterals[i], laterals[i - 1].shape[2:])
        return [getattr(self, f'fpn_{i}')(lat)
                for i, lat in enumerate(laterals)]
