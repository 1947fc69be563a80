"""MMAction-style 3D ResNets: ResNet3d, its SlowOnly pathway and the
SlowOnly with two last stages (NCTHW).

Port of ``mscl_tpu/models/backbones/resnet3d.py`` (``ARCH_SETTINGS``,
``BasicBlock3d``, ``Bottleneck3d`` in the 'pytorch' style, with the stride
on conv2, ``ResNet3d``, ``ResNet3dSlowOnly`` and
``ResNet3dSlowOnly_TwoR5``, whose last stage runs twice with its own
weights, ``layer{n}`` and ``layer{n}_local``, the (global, local) pair of
the TwoR5 necks). The module names are
mmaction's ConvModule names (``conv1.conv``, ``conv1.bn``,
``layer{i}.{j}.conv{1,2,3}.conv/.bn``, ``...downsample.conv/.bn``), so a
reference mmaction ``.pth`` loads as it is; ``mscl_torch/convert.py`` maps
the JAX tree's names (its Bottleneck3d's bare ``conv2_conv`` and
``conv2_bn`` included) onto them. BN is the JAX package's (biased running
variance), in the compute ``dtype`` as ``video_resnet.ConvBN``'s.

The init is the JAX package's: kaiming-normal fan_out convs, BN 1/0 (its
``zero_init_residual`` is accepted and, as there, not applied).

What no shipped config uses is refused by name: a non-zero ``non_local``,
``lateral=True``, ``frozen_stages >= 0``, ``norm_eval=True``,
``with_cp=True``, ``return_stem=True`` and a style other than 'pytorch'.
So is ``inflate_style='3x3x3'`` with Bottleneck blocks: the reference
passes the style to its blocks and the JAX ResNet3d does not (its blocks
always take '3x1x1'), so the two would disagree (``Bottleneck3d`` itself
takes either style).
"""
from __future__ import annotations

import copy
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .. import compute_dtype
from ..builder import BACKBONES
from ...ops.batch_norm import BatchNorm3d
from .video_resnet import Conv3dNoBias, make_bn

ARCH_SETTINGS = {
    18: ('basic', (2, 2, 2, 2)),
    34: ('basic', (3, 4, 6, 3)),
    50: ('bottleneck', (3, 4, 6, 3)),
    101: ('bottleneck', (3, 4, 23, 3)),
    152: ('bottleneck', (3, 8, 36, 3)),
}


def _triple(v) -> Tuple[int, int, int]:
    return (v,) * 3 if isinstance(v, int) else tuple(v)


class ConvModule(nn.Module):
    """mmcv's ConvModule as the configs build it: a bias-free Conv3d
    (``conv``), BN (``bn``), then a ReLU unless ``relu=False``."""

    def __init__(self, cin: int, cout: int, kernel, stride=1, padding=0,
                 dilation=1, relu: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = Conv3dNoBias(cin, cout, _triple(kernel), _triple(stride),
                                 _triple(padding), dtype, _triple(dilation))
        self.bn = make_bn(cout, dtype)
        self.relu = relu

    def forward(self, x):
        x = self.bn(self.conv(x))
        return F.relu(x, inplace=True) if self.relu else x


class BasicBlock3d(nn.Module):
    """Two 3x3x3 (inflated) or 1x3x3 convs, plus an identity or 1x1x1
    downsample."""
    expansion = 1

    def __init__(self, cin: int, planes: int, spatial_stride: int = 1,
                 temporal_stride: int = 1, dilation: int = 1,
                 inflate: bool = True, inflate_style: str = '3x1x1',
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        k = (3, 3, 3) if inflate else (1, 3, 3)
        pad = tuple(n // 2 for n in k)
        stride = (temporal_stride, spatial_stride, spatial_stride)
        self.conv1 = ConvModule(cin, planes, k, stride, pad, dtype=dtype)
        self.conv2 = ConvModule(planes, planes, k, 1, pad, relu=False,
                                dtype=dtype)
        self.downsample = None
        if stride != (1, 1, 1) or cin != planes:
            self.downsample = ConvModule(cin, planes, 1, stride, 0,
                                         relu=False, dtype=dtype)

    def forward(self, x):
        res = x if self.downsample is None else self.downsample(x)
        return F.relu(self.conv2(self.conv1(x)) + res, inplace=True)


class Bottleneck3d(nn.Module):
    """1x1x1 (3x1x1 inflated '3x1x1'), 1x3x3 (3x3x3 inflated '3x3x3') with
    the stride and dilation, 1x1x1 to 4x the planes; plus an identity or
    1x1x1 downsample."""
    expansion = 4

    def __init__(self, cin: int, planes: int, spatial_stride: int = 1,
                 temporal_stride: int = 1, dilation: int = 1,
                 inflate: bool = True, inflate_style: str = '3x1x1',
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if inflate_style not in ('3x1x1', '3x3x3'):
            raise ValueError(f'unknown inflate_style {inflate_style}')
        d = dilation
        if inflate and inflate_style == '3x1x1':
            k1, p1, k2, p2 = (3, 1, 1), (1, 0, 0), (1, 3, 3), (0, d, d)
        elif inflate:
            k1, p1, k2, p2 = (1, 1, 1), (0, 0, 0), (3, 3, 3), (1, d, d)
        else:
            k1, p1, k2, p2 = (1, 1, 1), (0, 0, 0), (1, 3, 3), (0, d, d)
        stride = (temporal_stride, spatial_stride, spatial_stride)
        out = planes * self.expansion
        self.conv1 = ConvModule(cin, planes, k1, 1, p1, dtype=dtype)
        self.conv2 = ConvModule(planes, planes, k2, stride, p2, (1, d, d),
                                dtype=dtype)
        self.conv3 = ConvModule(planes, out, 1, 1, 0, relu=False,
                                dtype=dtype)
        self.downsample = None
        if stride != (1, 1, 1) or cin != out:
            self.downsample = ConvModule(cin, out, 1, stride, 0, relu=False,
                                         dtype=dtype)

    def forward(self, x):
        res = x if self.downsample is None else self.downsample(x)
        out = self.conv3(self.conv2(self.conv1(x)))
        return F.relu(out + res, inplace=True)


def _refuse(name, value, default):
    if value != default:
        raise NotImplementedError(
            f'ResNet3d {name}={value!r} is not ported (no shipped config '
            f'uses it); leave it at {default!r}')


@BACKBONES.register_module()
class ResNet3d(nn.Module):
    """conv1 (``conv1_kernel`` at (``conv1_stride_t``, 2, 2)), a (1,3,3)
    max-pool at (``pool1_stride_t``, 2, 2), ``num_stages`` stages of
    BasicBlock3d or Bottleneck3d (a (2,1,1) max-pool after the first with
    ``with_pool2``); returns the stages of ``out_indices`` (one tensor if
    there is one index, else a list)."""
    conv1_kernel_default = (3, 7, 7)
    inflate_default = (1, 1, 1, 1)
    with_pool2_default = True

    def __init__(self, depth: int = 50, pretrained=None, stage_blocks=None,
                 pretrained2d: bool = True, in_channels: int = 3,
                 num_stages: int = 4, base_channels: int = 64,
                 out_indices: Sequence[int] = (3,),
                 spatial_strides: Sequence[int] = (1, 2, 2, 2),
                 temporal_strides: Sequence[int] = (1, 1, 1, 1),
                 dilations: Sequence[int] = (1, 1, 1, 1), conv1_kernel=None,
                 conv1_stride_s: int = 2, conv1_stride_t: int = 1,
                 pool1_stride_s: int = 2, pool1_stride_t: int = 1,
                 with_pool1: bool = True, with_pool2=None,
                 style: str = 'pytorch', frozen_stages: int = -1,
                 inflate=None, inflate_style: str = '3x1x1',
                 norm_eval: bool = False, with_cp: bool = False,
                 non_local=(0, 0, 0, 0), non_local_cfg=None,
                 zero_init_residual: bool = True, lateral: bool = False,
                 conv_cfg=None, norm_cfg=None, act_cfg=None,
                 return_stem: bool = False, dtype=None):
        super().__init__()
        if any(any(s) if isinstance(s, (list, tuple)) else s
               for s in (non_local or ())):
            raise NotImplementedError(
                'ResNet3d non_local (NonLocal3d) is not ported')
        for name, value, default in (
                ('lateral', lateral, False), ('frozen_stages', frozen_stages,
                                              -1),
                ('norm_eval', norm_eval, False), ('with_cp', with_cp, False),
                ('return_stem', return_stem, False), ('style', style,
                                                      'pytorch')):
            _refuse(name, value, default)
        dtype = compute_dtype.resolve_dtype(dtype)
        block_type, default_blocks = ARCH_SETTINGS[depth]
        if block_type == 'bottleneck' and inflate_style != '3x1x1':
            raise NotImplementedError(
                f'ResNet3d inflate_style={inflate_style!r} with Bottleneck '
                "blocks is not ported: the JAX ResNet3d gives its blocks "
                "'3x1x1' whatever the style, the reference passes it on")
        block_cls = BasicBlock3d if block_type == 'basic' else Bottleneck3d
        stage_blocks = stage_blocks or default_blocks[:num_stages]
        inflate = self.inflate_default if inflate is None else inflate
        if isinstance(inflate, int):
            inflate = (inflate,) * num_stages
        with_pool2 = self.with_pool2_default if with_pool2 is None \
            else with_pool2
        k = tuple(conv1_kernel or self.conv1_kernel_default)

        self.conv1 = ConvModule(
            in_channels, base_channels, k,
            (conv1_stride_t, conv1_stride_s, conv1_stride_s),
            tuple((n - 1) // 2 for n in k), dtype=dtype)
        self.pool1 = nn.MaxPool3d(
            (1, 3, 3), (pool1_stride_t, pool1_stride_s, pool1_stride_s),
            (0, 1, 1)) if with_pool1 else None
        self.pool2 = nn.MaxPool3d((2, 1, 1), (2, 1, 1)) if with_pool2 \
            else None
        self.out_indices = tuple(out_indices)
        self.num_stages = len(stage_blocks)
        cin = base_channels
        for i, num_blocks in enumerate(stage_blocks):
            planes = base_channels * 2 ** i
            blocks = []
            for b in range(num_blocks):
                inf = inflate[i][b] if isinstance(inflate[i], (list, tuple)) \
                    else inflate[i]
                first = b == 0
                blocks.append(block_cls(
                    cin, planes,
                    spatial_stride=spatial_strides[i] if first else 1,
                    temporal_stride=temporal_strides[i] if first else 1,
                    dilation=dilations[i], inflate=bool(inf),
                    inflate_style=inflate_style, dtype=dtype))
                cin = planes * block_cls.expansion
            setattr(self, f'layer{i + 1}', nn.Sequential(*blocks))

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator):
        """kaiming-normal fan_out convs, BN 1/0 (the JAX package's init)."""
        for m in self.modules():
            if isinstance(m, nn.Conv3d):
                nn.init.kaiming_normal_(m.weight, mode='fan_out',
                                        nonlinearity='relu', generator=gen)
            elif isinstance(m, BatchNorm3d):
                m.weight.fill_(1.0)
                m.bias.zero_()

    def forward(self, x):
        x = self.conv1(x)
        if self.pool1 is not None:
            x = self.pool1(x)
        outs = []
        for i in range(self.num_stages):
            x = getattr(self, f'layer{i + 1}')(x)
            if i == 0 and self.pool2 is not None:
                x = self.pool2(x)
            outs.append(x)
        outs = [outs[i] for i in self.out_indices]
        return outs[0] if len(outs) == 1 else outs


@BACKBONES.register_module()
class ResNet3dSlowOnly(ResNet3d):
    """The SlowOnly pathway: ResNet3d with conv1 (1,7,7), inflate
    (0,0,1,1) and no pool2 by default."""
    conv1_kernel_default = (1, 7, 7)
    inflate_default = (0, 0, 1, 1)
    with_pool2_default = False


@BACKBONES.register_module()
class ResNet3dSlowOnly_TwoR5(ResNet3dSlowOnly):
    """ResNet3dSlowOnly whose last stage is duplicated with independent
    weights (``layer{n}_local``; reference resnet3d_slowonly.py:56-123).
    Returns, as the JAX module does, the stages of ``out_indices`` before
    the last and, if the last is among them, the (global, local) pair after
    them; one element bare, several as a tuple. So with the default
    ``out_indices=(3,)`` it returns the bare pair, which the TwoR5 neck
    refuses: give it the last stage and at least one other."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        last = f'layer{self.num_stages}'
        setattr(self, f'{last}_local', copy.deepcopy(getattr(self, last)))

    def forward(self, x):
        x = self.conv1(x)
        if self.pool1 is not None:
            x = self.pool1(x)
        outs = []
        last = self.num_stages - 1
        for i in range(last):
            x = getattr(self, f'layer{i + 1}')(x)
            if i == 0 and self.pool2 is not None:
                x = self.pool2(x)
            if i in self.out_indices:
                outs.append(x)
        if last in self.out_indices:
            outs.append((getattr(self, f'layer{last + 1}')(x),
                         getattr(self, f'layer{last + 1}_local')(x)))
        return outs[0] if len(outs) == 1 else tuple(outs)
