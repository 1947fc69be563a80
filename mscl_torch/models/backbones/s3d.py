"""S3D, the separable 3D Inception (NCTHW).

Port of ``mscl_tpu/models/backbones/s3d.py`` (reference mmaction
backbones/s3d.py, S3D-G without the gating): Inception-V1's topology with
every kxkxk conv factorised into a (1,k,k) spatial ConvBN-ReLU and a
(k,1,1) temporal one (``SepConv3d``: ``conv_s``, ``conv_t``). Module names
are the JAX tree's (``conv1``, ``conv2b``, ``conv2c``, ``mixed_{3b..5c}``
with ``b0``, ``b1_reduce``, ``b1``, ``b2_reduce``, ``b2``, ``b3``), each
ConvBN a ``ConvModule`` (``conv``, ``bn``); the init is the JAX package's
(kaiming-normal fan_out convs, BN 1/0).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .. import compute_dtype
from ..builder import BACKBONES
from .resnet3d import init_convs_bn
from .video_resnet import ConvModule

# the Inception blocks (Mixed_3b .. Mixed_5c): (out_1x1, mid_3x3, out_3x3,
# mid_d3x3, out_d3x3, out_pool); 'pool' a (2,2,2) max-pool at stride 2
_INCEPTION = [
    ('3b', (64, 96, 128, 16, 32, 32)),
    ('3c', (128, 128, 192, 32, 96, 64)),
    ('pool', None),
    ('4b', (192, 96, 208, 16, 48, 64)),
    ('4c', (160, 112, 224, 24, 64, 64)),
    ('4d', (128, 128, 256, 24, 64, 64)),
    ('4e', (112, 144, 288, 32, 64, 64)),
    ('4f', (256, 160, 320, 32, 128, 128)),
    ('pool', None),
    ('5b', (256, 160, 320, 32, 128, 128)),
    ('5c', (384, 192, 384, 48, 128, 128)),
]


class SepConv3d(nn.Module):
    """A (1,k,k) ConvBN-ReLU at (1,s,s), then a (k,1,1) one at (t,1,1)."""

    def __init__(self, cin: int, features: int, kernel: int = 3,
                 stride=(1, 1, 1), dtype: torch.dtype = torch.float32):
        super().__init__()
        k, (st, ss) = kernel, (stride[0], stride[1])
        self.conv_s = ConvModule(cin, features, (1, k, k), (1, ss, ss),
                                 (0, k // 2, k // 2), dtype=dtype)
        self.conv_t = ConvModule(features, features, (k, 1, 1), (st, 1, 1),
                                 (k // 2, 0, 0), dtype=dtype)

    def forward(self, x):
        return self.conv_t(self.conv_s(x))


class InceptionS3D(nn.Module):
    """Four branches concatenated on the channel axis: a 1x1x1 ConvBN; a
    1x1x1 reduce then a SepConv3d, twice; a 3x3x3 max-pool at stride 1
    then a 1x1x1 ConvBN."""

    def __init__(self, cin: int, cfg, dtype: torch.dtype = torch.float32):
        super().__init__()
        c1, m3, c3, md3, cd3, cp = cfg
        self.b0 = ConvModule(cin, c1, 1, dtype=dtype)
        self.b1_reduce = ConvModule(cin, m3, 1, dtype=dtype)
        self.b1 = SepConv3d(m3, c3, 3, dtype=dtype)
        self.b2_reduce = ConvModule(cin, md3, 1, dtype=dtype)
        self.b2 = SepConv3d(md3, cd3, 3, dtype=dtype)
        self.b3 = ConvModule(cin, cp, 1, dtype=dtype)
        self.out_channels = c1 + c3 + cd3 + cp

    def forward(self, x):
        return torch.cat([
            self.b0(x), self.b1(self.b1_reduce(x)), self.b2(self.b2_reduce(x)),
            self.b3(F.max_pool3d(x, 3, 1, 1))], dim=1)


@BACKBONES.register_module()
class S3D(nn.Module):
    """conv1 (SepConv3d 7 at (2,2,2)), a (1,3,3) max-pool at (1,2,2),
    conv2b (1x1x1), conv2c (SepConv3d 3 to 192), the max-pool again, then
    the Inception blocks: (N, 1024, T/8, H/32, W/32)."""

    def __init__(self, pretrained=None, in_channels: int = 3, dtype=None):
        super().__init__()
        dtype = compute_dtype.resolve_dtype(dtype)
        self.conv1 = SepConv3d(in_channels, 64, 7, (2, 2, 2), dtype=dtype)
        self.conv2b = ConvModule(64, 64, 1, dtype=dtype)
        self.conv2c = SepConv3d(64, 192, 3, dtype=dtype)
        cin = 192
        for name, cfg in _INCEPTION:
            if cfg is not None:
                block = InceptionS3D(cin, cfg, dtype)
                setattr(self, f'mixed_{name}', block)
                cin = block.out_channels

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator):
        init_convs_bn(self, gen)

    def forward(self, x):
        x = F.max_pool3d(self.conv1(x), (1, 3, 3), (1, 2, 2), (0, 1, 1))
        x = self.conv2c(self.conv2b(x))
        x = F.max_pool3d(x, (1, 3, 3), (1, 2, 2), (0, 1, 1))
        for name, cfg in _INCEPTION:
            x = F.max_pool3d(x, 2, 2) if cfg is None else \
                getattr(self, f'mixed_{name}')(x)
        return x
