"""2D ResNets over frames (TSN, TSM) and the C3D backbone.

Port of ``mscl_tpu/models/backbones/resnet2d.py``: ``ConvBN2d``,
``temporal_shift``, ``BasicBlock2d``, ``Bottleneck2d``, ``ResNet``,
``ResNetTSM`` and ``C3D``. The frames of a clip run as the batch, NCHW
(N * segments, C, H, W); C3D takes NCTHW clips.

- ``temporal_shift`` moves 1/shift_div of the channels one segment back
  and 1/shift_div one segment forward, zero-filled (the TSM shift, before
  each residual block's conv1 when ``shift`` and ``is_shift``). It is a
  tensor copy on every device, as the JAX one is plain ``jnp`` outside any
  kernel.
- ``temporal_pool`` max-pools the segments (3 wide, stride 2, padded with
  -inf) before layer2, halving them for the rest of the stack.
- ``non_local`` puts a ``NonLocal3d`` after each flagged block, over the
  segments as its time axis (``layer{i}_{b}_nonlocal``).
- ``norm_eval`` keeps BN on its running statistics while training.

``partial_bn`` and ``frozen_stages`` are accepted and ignored, as the JAX
module ignores them: every BN trains and every stage learns. ``norm_cfg`` is
accepted for the configs' sake (BN is fixed). ``pretrained`` names a
download and is dropped by the recognizer.

Names follow mmaction's: ``conv1.conv``, ``conv1.bn``,
``layer{i}.{j}.conv{1,2,3}.conv/.bn``, ``...downsample.conv/.bn``; C3D's
``conv{1a..5b}``; ``mscl_torch/convert.py`` maps the JAX tree onto them. The
init is the JAX package's: kaiming-normal fan_out convs (zero biases), BN
1/0.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .. import compute_dtype
from ..builder import BACKBONES
from ...ops.batch_norm import BatchNorm3d
from .resnet3d import _non_local, _non_local_flag, init_convs_bn
from .video_resnet import make_bn

ARCH = {
    18: ('basic', (2, 2, 2, 2)),
    34: ('basic', (3, 4, 6, 3)),
    50: ('bottleneck', (3, 4, 6, 3)),
    101: ('bottleneck', (3, 4, 23, 3)),
    152: ('bottleneck', (3, 8, 36, 3)),
}


class Conv2d(nn.Conv2d):
    """A Conv2d that computes in ``dtype`` (x and kernel cast)."""

    def __init__(self, *args, dtype: torch.dtype = torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = dtype

    def forward(self, x):
        return compute_dtype.conv(self, x, self.compute_dtype)


class ConvBN2d(nn.Module):
    """Bias-free Conv2d (``conv``), BN (``bn``), then a ReLU unless
    ``relu=False``."""

    def __init__(self, cin: int, cout: int, kernel=3, stride=1, padding=1,
                 relu: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = Conv2d(cin, cout, kernel, stride, padding, bias=False,
                           dtype=dtype)
        self.bn = make_bn(cout, dtype)
        self.relu = relu

    def forward(self, x):
        x = self.bn(self.conv(x))
        return F.relu(x) if self.relu else x


def temporal_shift(x: torch.Tensor, num_segments: int,
                   shift_div: int = 8) -> torch.Tensor:
    """The TSM shift over (N * T, C, H, W): channels [0, C/div) take the
    next segment's values, [C/div, 2C/div) the previous one's, zero at the
    ends; the rest stay."""
    nt, c, h, w = x.shape
    x = x.reshape(nt // num_segments, num_segments, c, h, w)
    fold = c // shift_div
    out = torch.zeros_like(x)
    out[:, :-1, :fold] = x[:, 1:, :fold]
    out[:, 1:, fold:2 * fold] = x[:, :-1, fold:2 * fold]
    out[:, :, 2 * fold:] = x[:, :, 2 * fold:]
    return out.reshape(nt, c, h, w)


class BasicBlock2d(nn.Module):
    expansion = 1

    def __init__(self, cin: int, planes: int, stride: int = 1,
                 downsample: bool = False, shift: bool = False,
                 num_segments: int = 8, shift_div: int = 8,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.shift, self.num_segments, self.shift_div = \
            shift, num_segments, shift_div
        self.conv1 = ConvBN2d(cin, planes, 3, stride, 1, dtype=dtype)
        self.conv2 = ConvBN2d(planes, planes, 3, 1, 1, relu=False,
                              dtype=dtype)
        self.downsample = ConvBN2d(cin, planes, 1, stride, 0, relu=False,
                                   dtype=dtype) if downsample else None

    def residual(self, x):
        y = temporal_shift(x, self.num_segments, self.shift_div) \
            if self.shift else x
        return self.conv2(self.conv1(y))

    def forward(self, x):
        res = x if self.downsample is None else self.downsample(x)
        return F.relu(self.residual(x) + res)


class Bottleneck2d(BasicBlock2d):
    expansion = 4

    def __init__(self, cin: int, planes: int, stride: int = 1,
                 downsample: bool = False, shift: bool = False,
                 num_segments: int = 8, shift_div: int = 8,
                 dtype: torch.dtype = torch.float32):
        nn.Module.__init__(self)
        self.shift, self.num_segments, self.shift_div = \
            shift, num_segments, shift_div
        out = planes * 4
        self.conv1 = ConvBN2d(cin, planes, 1, 1, 0, dtype=dtype)
        self.conv2 = ConvBN2d(planes, planes, 3, stride, 1, dtype=dtype)
        self.conv3 = ConvBN2d(planes, out, 1, 1, 0, relu=False, dtype=dtype)
        self.downsample = ConvBN2d(cin, out, 1, stride, 0, relu=False,
                                   dtype=dtype) if downsample else None

    def residual(self, x):
        return self.conv3(super().residual(x))


@BACKBONES.register_module()
class ResNet(nn.Module):
    """2D ResNet over (N * T, C, H, W) frames; returns the stages of
    ``out_indices`` (one tensor if there is one index, else a list)."""
    shift_default = False

    def __init__(self, depth: int = 50, pretrained=None, in_channels: int = 3,
                 num_stages: int = 4, out_indices: Sequence[int] = (3,),
                 strides: Sequence[int] = (1, 2, 2, 2),
                 frozen_stages: int = -1, norm_eval: bool = False,
                 norm_cfg=None, partial_bn: bool = False, shift=None,
                 is_shift: bool = True, num_segments: int = 8,
                 shift_div: int = 8, non_local=(0, 0, 0, 0),
                 non_local_cfg=None, temporal_pool: bool = False,
                 dtype=None):
        super().__init__()
        dtype = compute_dtype.resolve_dtype(dtype)
        block_type, blocks = ARCH[depth]
        block_cls = BasicBlock2d if block_type == 'basic' else Bottleneck2d
        shift = (self.shift_default if shift is None else shift) and is_shift
        make_block = self.block_maker(block_type, shift, shift_div, dtype)
        self.norm_eval, self.temporal_pool = norm_eval, temporal_pool
        self.num_segments = num_segments
        self.out_indices = tuple(out_indices)
        self.num_stages = num_stages
        self.conv1 = ConvBN2d(in_channels, 64, 7, 2, 3, dtype=dtype)
        cin, segs = 64, num_segments
        for i in range(num_stages):
            if i == 1 and temporal_pool:
                segs //= 2
            planes = 64 * 2 ** i
            layer = []
            for b in range(blocks[i]):
                stride = strides[i] if b == 0 else 1
                need_ds = b == 0 and (stride != 1 or
                                      cin != planes * block_cls.expansion)
                layer.append(make_block(cin, planes, stride, need_ds, segs))
                cin = planes * block_cls.expansion
                if _non_local_flag(non_local, i, b):
                    setattr(self, f'layer{i + 1}_{b}_nonlocal',
                            _non_local(cin, non_local_cfg, dtype))
            setattr(self, f'layer{i + 1}', nn.Sequential(*layer))

    @staticmethod
    def block_maker(block_type: str, shift: bool, shift_div: int, dtype):
        """(cin, planes, stride, downsample, segments) -> a residual block:
        ResNet's plain or shifted blocks; ResNetTIN and TANet give their
        own."""
        block_cls = BasicBlock2d if block_type == 'basic' else Bottleneck2d

        def make(cin, planes, stride, downsample, segs):
            return block_cls(cin, planes, stride, downsample, shift=shift,
                             num_segments=segs, shift_div=shift_div,
                             dtype=dtype)
        return make

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator):
        init_convs_bn(self, gen)
        for m in self.modules():
            if hasattr(m, 'init_weights') and m is not self:
                m.init_weights(gen)

    def train(self, mode: bool = True):
        """``norm_eval``: BN keeps its running statistics in training."""
        super().train(mode)
        if mode and self.norm_eval:
            for m in self.modules():
                if isinstance(m, BatchNorm3d):
                    m.eval()
        return self

    @staticmethod
    def _segment_pool(x, segs):
        """(N * T, C, H, W) -> (N * ceil(T / 2), C, H, W): the max over
        segments t - 1, t, t + 1 at every other t, -inf beyond the ends."""
        nt, c, h, w = x.shape
        xt = x.reshape(nt // segs, segs, c, h, w).transpose(1, 2)
        xt = F.max_pool3d(xt, (3, 1, 1), (2, 1, 1), (1, 0, 0))
        return xt.transpose(1, 2).reshape(-1, c, h, w)

    def _non_local(self, x, i, b, segs):
        nl = getattr(self, f'layer{i + 1}_{b}_nonlocal', None)
        if nl is None:
            return x
        nt, c, h, w = x.shape
        xt = x.reshape(nt // segs, segs, c, h, w).transpose(1, 2)
        return nl(xt).transpose(1, 2).reshape(nt, c, h, w)

    def forward(self, x):
        x = F.max_pool2d(self.conv1(x), 3, 2, 1)
        outs, segs = [], self.num_segments
        for i in range(self.num_stages):
            if i == 1 and self.temporal_pool:
                x = self._segment_pool(x, segs)
                segs //= 2
            for b, block in enumerate(getattr(self, f'layer{i + 1}')):
                x = self._non_local(block(x), i, b, segs)
            outs.append(x)
        outs = [outs[i] for i in self.out_indices]
        return outs[0] if len(outs) == 1 else outs


@BACKBONES.register_module()
class ResNetTSM(ResNet):
    """The TSM backbone: ResNet with the temporal shift before every
    residual block."""
    shift_default = True


@BACKBONES.register_module()
class C3D(nn.Module):
    """C3D over NCTHW clips: eight 3x3x3 convs with a bias and a ReLU, max
    pools (1,2,2) after conv1a and (2,2,2) after conv2a, conv3b and conv4b;
    returns conv5b's map (the head pools it). ``style``, ``conv_cfg``,
    ``norm_cfg``, ``act_cfg``, ``dropout_ratio`` and ``init_std`` are the
    configs' surface, accepted as the JAX module accepts them."""
    WIDTHS = (('conv1a', 64), ('pool', 1), ('conv2a', 128), ('pool', 2),
              ('conv3a', 256), ('conv3b', 256), ('pool', 2),
              ('conv4a', 512), ('conv4b', 512), ('pool', 2),
              ('conv5a', 512), ('conv5b', 512))

    def __init__(self, pretrained=None, style: str = 'pytorch', conv_cfg=None,
                 norm_cfg=None, act_cfg=None, dropout_ratio: float = 0.5,
                 init_std: float = 0.005, dtype=None):
        super().__init__()
        self.dtype = compute_dtype.resolve_dtype(dtype)
        cin = 3                         # RGB clips, as every config gives
        for name, width in self.WIDTHS:
            if name != 'pool':
                setattr(self, name, nn.Conv3d(cin, width, 3, 1, 1))
                cin = width

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator):
        init_convs_bn(self, gen)

    def forward(self, x):
        for name, width in self.WIDTHS:
            if name == 'pool':
                x = F.max_pool3d(x, (width, 2, 2), (width, 2, 2))
            else:
                x = F.relu(compute_dtype.conv(getattr(self, name), x,
                                              self.dtype))
        return x
