"""ResNetTIN: the Temporal Interlace Network backbone over frames (NCHW).

Port of ``mscl_tpu/models/backbones/resnet_tin.py`` (reference mmaction
resnet_tin.py):

- ``tin_shift``: channel group g of sample n moved by offset[n, g]
  segments, zero-filled (the mmcv CUDA op; here a gather, on every
  device, as the JAX one is a ``take_along_axis``);
- ``linear_sampler``: the floor and ceil shifts blended by the fractional
  offset; the blend weights carry the offset's gradient, the integer
  shifts none;
- ``OffsetNet``: conv1d (C -> 1, 3 wide) over the segments, fc (T -> T),
  ReLU, fc (T -> groups, bias 0.5108), then 4 (sigmoid - 1/2), in (-2, 2);
- ``WeightNet``: conv1d (C -> groups, 3 wide), 2 sigmoid, in (0, 2);
- ``TemporalInterlace``: the first 1/shift_div channels shifted by the
  offsets and their mirror (+o0, +o1, -o0, -o1), gated by the weights
  (the mirrored groups reuse the same gates), the rest passed through;
- ``ResNetTIN``: ResNet whose every block applies the interlace to the
  conv1 path's input only (the identity sees the raw input); with
  ``is_tin=False`` plain blocks.

The conv1d kernels are torch's (out, in, 3) (JAX: (3, in, out));
``mscl_torch/convert.py`` transposes them. ``norm_cfg`` is accepted, as the
JAX module accepts it.
"""
from __future__ import annotations

import torch
from torch import nn

from .. import compute_dtype
from ..builder import BACKBONES
from ..weight_init import lecun_normal_
from .resnet2d import BasicBlock2d, Bottleneck2d, ResNet


def tin_shift(data: torch.Tensor, offset: torch.Tensor) -> torch.Tensor:
    """data (N, T, C, S), offset (N, G) integers: out[n, t, c] =
    data[n, t - offset[n, c // (C / G)], c], 0 where that is outside
    [0, T)."""
    n, t, c, s = data.shape
    off_c = offset.repeat_interleave(c // offset.shape[1], dim=1)  # (N, C)
    src = torch.arange(t, device=data.device)[None, :, None] - \
        off_c[:, None, :]                                          # (N, T, C)
    valid = (src >= 0) & (src < t)
    src = src.clamp(0, t - 1)
    out = data.gather(1, src[..., None].expand(n, t, c, s))
    return out * valid[..., None].to(data.dtype)


def linear_sampler(data: torch.Tensor, offset: torch.Tensor) -> torch.Tensor:
    """data (N, T, C, H, W), offset (N, G) real: the shifts by floor and
    floor + 1, weighted 1 - frac and frac."""
    n, t, c, h, w = data.shape
    offset0 = torch.floor(offset).long()
    flat = data.reshape(n, t, c, h * w)
    data0 = tin_shift(flat, offset0)
    data1 = tin_shift(flat, offset0 + 1)
    w0 = 1 - (offset - offset0.to(offset.dtype))                   # (N, G)
    w0 = w0.repeat_interleave(c // offset.shape[1], dim=1)[:, None, :, None]
    return (w0 * data0 + (1 - w0) * data1).reshape(n, t, c, h, w)


def _flax_default_init(module: nn.Module, gen: torch.Generator) -> None:
    """flax's defaults for the Conv1d and Linear layers inside:
    lecun-normal kernels (truncated at 2 std), zero biases."""
    for m in module.modules():
        if isinstance(m, (nn.Conv1d, nn.Linear)):
            lecun_normal_(m.weight, gen)
            if m.bias is not None:
                m.bias.zero_()


class OffsetNet(nn.Module):

    def __init__(self, channels: int, groups: int, num_segments: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv = nn.Conv1d(channels, 1, 3, padding=1)
        self.fc1 = nn.Linear(num_segments, num_segments)
        self.fc2 = nn.Linear(num_segments, groups)

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator):
        _flax_default_init(self, gen)
        self.fc2.bias.fill_(0.5108)

    def forward(self, x):
        """x (N, C, T) pooled -> offsets (N, groups)."""
        x = compute_dtype.conv(self.conv, x, self.dtype)[:, 0]      # (N, T)
        x = torch.relu(compute_dtype.linear(self.fc1, x, self.dtype))
        x = compute_dtype.linear(self.fc2, x, self.dtype)
        return 4.0 * (torch.sigmoid(x) - 0.5)


class WeightNet(nn.Module):

    def __init__(self, channels: int, groups: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv = nn.Conv1d(channels, groups, 3, padding=1)

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator):
        _flax_default_init(self, gen)

    def forward(self, x):
        """x (N, C, T) -> gates (N, T, groups)."""
        x = compute_dtype.conv(self.conv, x, self.dtype)
        return 2.0 * torch.sigmoid(x).transpose(1, 2)


class TemporalInterlace(nn.Module):

    def __init__(self, channels: int, num_segments: int = 8,
                 shift_div: int = 4, deform_groups: int = 2,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_segments, self.deform_groups = num_segments, deform_groups
        self.num_folds = channels // shift_div
        self.offset_net = OffsetNet(self.num_folds, deform_groups,
                                    num_segments, dtype)
        self.weight_net = WeightNet(self.num_folds, deform_groups, dtype)

    def forward(self, x):
        nt, c, h, w = x.shape
        t, f = self.num_segments, self.num_folds
        xd = x[:, :f].reshape(nt // t, t, f, h, w)
        pooled = xd.mean(dim=(3, 4)).transpose(1, 2)               # (N, F, T)
        offset = self.offset_net(pooled)                           # (N, G)
        weight = self.weight_net(pooled)                           # (N, T, G)
        xs = linear_sampler(xd, torch.cat([offset, -offset], dim=1))
        gate = weight.repeat(1, 1, 2).repeat_interleave(
            f // (2 * self.deform_groups), dim=2)                  # (N, T, F)
        xs = (xs * gate[..., None, None]).reshape(nt, f, h, w)
        return torch.cat([xs, x[:, f:]], dim=1)


class _Interlaced:
    """A residual block whose conv1 path reads the interlaced input."""

    def residual(self, x):
        return super().residual(self.tin(x))


class TINBasicBlock(_Interlaced, BasicBlock2d):
    pass


class TINBottleneck(_Interlaced, Bottleneck2d):
    pass


@BACKBONES.register_module()
class ResNetTIN(ResNet):

    def __init__(self, depth: int = 50, num_segments: int = 8,
                 is_tin: bool = True, shift_div: int = 4, pretrained=None,
                 norm_eval: bool = False, norm_cfg=None, dtype=None):
        self.is_tin = is_tin
        super().__init__(depth=depth, num_segments=num_segments,
                         shift_div=shift_div, norm_eval=norm_eval,
                         dtype=dtype)

    def block_maker(self, block_type, shift, shift_div, dtype):
        if not self.is_tin:
            return super().block_maker(block_type, False, shift_div, dtype)
        block_cls = TINBasicBlock if block_type == 'basic' else TINBottleneck

        def make(cin, planes, stride, downsample, segs):
            block = block_cls(cin, planes, stride, downsample, dtype=dtype)
            block.tin = TemporalInterlace(cin, segs, shift_div, dtype=dtype)
            return block
        return make
