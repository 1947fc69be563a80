"""MMAction-style 3D ResNets: ResNet3d and its pathway options, the SlowOnly
pathway, SlowFast, the channel-separated CSN, one stage alone
(ResNet3dLayer) and the SlowOnly with two last stages (NCTHW).

Port of ``mscl_tpu/models/backbones/resnet3d.py`` (``ARCH_SETTINGS``,
``BasicBlock3d``, ``Bottleneck3d`` in the 'pytorch' style, with the stride
on conv2, ``ResNet3d``, ``ResNet3dSlowOnly``, ``ResNet3dSlowFast``,
``ResNet3dCSN`` with its bottleneck, ``ResNet3dLayer`` and
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
``zero_init_residual`` is accepted and, as there, not applied); SlowFast's
lateral convs take flax's default (lecun-normal).

``non_local`` puts a ``NonLocal3d`` after each flagged block
(``layer{i}_{b}_nonlocal``, the JAX tree's name, which ``convert.py``
keeps), in ResNet3d and ResNet3dSlowOnly; ResNet3dSlowOnly_TwoR5 refuses it,
as the JAX module accepts it and builds none, and refuses the pathway
options by name too (``lateral``, ``return_stem``, ``norm_eval``,
``frozen_stages``, ``with_cp``), which the JAX module does not read.

A style other than 'pytorch' is refused by name. So is
``inflate_style='3x3x3'`` with Bottleneck blocks in ResNet3d: the reference
passes the style to its blocks and the JAX ResNet3d does not (its blocks
always take '3x1x1'), so the two would disagree (``Bottleneck3d`` itself
takes either style, and ResNet3dCSN's own bottleneck its depthwise
3x3x3).
"""
from __future__ import annotations

import copy
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .. import compute_dtype
from ..builder import BACKBONES
from ...ops.batch_norm import BatchNorm3d
from ..weight_init import lecun_normal_
from .video_resnet import (Conv3dNoBias, ConvModule, make_bn,
                           stop_gradient)

ARCH_SETTINGS = {
    18: ('basic', (2, 2, 2, 2)),
    34: ('basic', (3, 4, 6, 3)),
    50: ('bottleneck', (3, 4, 6, 3)),
    101: ('bottleneck', (3, 4, 23, 3)),
    152: ('bottleneck', (3, 8, 36, 3)),
}


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


class NonLocal3d(nn.Module):
    """The embedded-gaussian non-local block (mmcv NonLocal3d as the
    reference nl configs set it) over NCTHW: attention over every (t, h, w)
    position, y = softmax(theta . phi^T) g (``use_scale``: the logits over
    sqrt of the inner width; 'dot_product': over the key count, no softmax;
    'gaussian': on the raw features), ``sub_sample`` a (1, 2, 2) max-pool
    on the phi and g inputs; out = x + BN(conv_out(y)), the BN's scale
    initialised to 0, so the block starts as the identity. 1x1x1 convs with
    a bias, named as the JAX module's: ``g``, ``theta``, ``phi``,
    ``conv_out``, ``bn_out``."""

    def __init__(self, in_channels: int, reduction: int = 2,
                 use_scale: bool = True, sub_sample: bool = False,
                 mode: str = 'embedded_gaussian',
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if mode not in ('embedded_gaussian', 'gaussian', 'dot_product'):
            raise ValueError(f'NonLocal3d mode {mode!r}')
        ic = max(in_channels // reduction, 1)
        self.mode, self.use_scale, self.sub_sample = mode, use_scale, \
            sub_sample
        self.inter, self.dtype = ic, dtype
        self.g = nn.Conv3d(in_channels, ic, 1)
        if mode != 'gaussian':
            self.theta = nn.Conv3d(in_channels, ic, 1)
            self.phi = nn.Conv3d(in_channels, ic, 1)
        self.conv_out = nn.Conv3d(ic, in_channels, 1)
        self.bn_out = make_bn(in_channels, dtype)

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator):
        """kaiming-normal fan_out kernels, zero biases, BN scale 0."""
        for m in self.modules():
            if isinstance(m, nn.Conv3d):
                nn.init.kaiming_normal_(m.weight, mode='fan_out',
                                        nonlinearity='relu', generator=gen)
                m.bias.zero_()
        self.bn_out.weight.zero_()
        self.bn_out.bias.zero_()

    def forward(self, x):
        n, c, t, h, w = x.shape
        kv_in = F.max_pool3d(x, (1, 2, 2), (1, 2, 2)) if self.sub_sample \
            else x

        def flat(v):                        # (n, c', ...) -> (n, pos, c')
            return v.reshape(n, v.shape[1], -1).transpose(1, 2)
        v = flat(compute_dtype.conv(self.g, kv_in, self.dtype))
        if self.mode == 'gaussian':
            q, k = flat(x), flat(kv_in)
        else:
            q = flat(compute_dtype.conv(self.theta, x, self.dtype))
            k = flat(compute_dtype.conv(self.phi, kv_in, self.dtype))
        attn = q @ k.transpose(1, 2)
        if self.mode == 'dot_product':
            attn = attn / attn.shape[-1]
        else:
            if self.mode == 'embedded_gaussian' and self.use_scale:
                attn = attn / torch.sqrt(attn.new_tensor(float(self.inter)))
            attn = attn.softmax(dim=-1)
        y = (attn @ v).transpose(1, 2).reshape(n, self.inter, t, h, w)
        return x + self.bn_out(compute_dtype.conv(self.conv_out, y,
                                                  self.dtype))


def _non_local_flag(spec, stage: int, block: int) -> bool:
    """Whether block ``block`` of stage ``stage`` is followed by a non-local
    block: ``spec`` a flag a stage or a list of flags a block."""
    if not spec:
        return False
    stage_spec = spec[stage] if stage < len(spec) else 0
    if isinstance(stage_spec, (list, tuple)):
        return bool(stage_spec[block]) if block < len(stage_spec) else False
    return bool(stage_spec)


def _non_local(channels: int, cfg, dtype) -> NonLocal3d:
    cfg = dict(cfg or {})
    cfg.pop('norm_cfg', None)           # BN is the block's default
    return NonLocal3d(channels, dtype=dtype, **cfg)


def init_convs_bn(module: nn.Module, gen: torch.Generator) -> None:
    """The JAX package's init: kaiming-normal fan_out conv kernels, zero
    conv biases, BN 1/0."""
    for m in module.modules():
        if isinstance(m, (nn.Conv1d, nn.Conv2d, nn.Conv3d)):
            nn.init.kaiming_normal_(m.weight, mode='fan_out',
                                    nonlinearity='relu', generator=gen)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, BatchNorm3d):
            m.weight.fill_(1.0)
            m.bias.zero_()


def _refuse(owner, name, value, default):
    if value != default:
        raise NotImplementedError(
            f'{owner} {name}={value!r} is not ported; leave it at '
            f'{default!r}')


@BACKBONES.register_module()
class ResNet3d(nn.Module):
    """conv1 (``conv1_kernel`` at (``conv1_stride_t``, 2, 2)), a (1,3,3)
    max-pool at (``pool1_stride_t``, 2, 2), ``num_stages`` stages of
    BasicBlock3d or Bottleneck3d (a (2,1,1) max-pool after the first with
    ``with_pool2``); returns the stages of ``out_indices`` (one tensor if
    there is one index, else a list).

    - ``forward(x, laterals)``: before stage i, ``laterals[i]`` (unless
      None) is concatenated to its input on the channel axis, as the JAX
      module's extra input; ``lateral_inplanes[i]`` (the port's own
      argument: torch sizes a conv when it is built) gives its channels.
      The ``lateral`` flag itself is read only by ResNet3dSlowFast.
    - ``return_stem``: returns (the post-pool1 stem, the list of stages).
    - ``norm_eval``: every BN runs on its running statistics in training
      too (``model.train()`` leaves them in eval mode).
    - ``frozen_stages`` and ``with_cp`` are accepted and, as in the JAX
      module, not applied: nothing is frozen and nothing checkpointed.
    """
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
                 return_stem: bool = False, lateral_inplanes=(0, 0, 0, 0),
                 dtype=None):
        super().__init__()
        _refuse(type(self).__name__, 'style', style, 'pytorch')
        dtype = compute_dtype.resolve_dtype(dtype)
        block_type, default_blocks = ARCH_SETTINGS[depth]
        self._check_inflate_style(block_type, inflate_style)
        block_cls = BasicBlock3d if block_type == 'basic' else Bottleneck3d
        stage_blocks = stage_blocks or default_blocks[:num_stages]
        inflate = self.inflate_default if inflate is None else inflate
        if isinstance(inflate, int):
            inflate = (inflate,) * num_stages
        with_pool2 = self.with_pool2_default if with_pool2 is None \
            else with_pool2
        self._stem(in_channels, base_channels, conv1_kernel, conv1_stride_s,
                   conv1_stride_t, pool1_stride_s, pool1_stride_t,
                   with_pool1, dtype)
        self.pool2 = nn.MaxPool3d((2, 1, 1), (2, 1, 1)) if with_pool2 \
            else None
        self.out_indices = tuple(out_indices)
        self.num_stages = len(stage_blocks)
        self.norm_eval = norm_eval
        self.return_stem = return_stem
        self.lateral_inplanes = tuple(lateral_inplanes)
        cin = base_channels
        for i, num_blocks in enumerate(stage_blocks):
            planes = base_channels * 2 ** i
            cin += self.lateral_inplanes[i] if i < len(
                self.lateral_inplanes) else 0
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
                if _non_local_flag(non_local, i, b):
                    setattr(self, f'layer{i + 1}_{b}_nonlocal',
                            _non_local(cin, non_local_cfg, dtype))
            setattr(self, f'layer{i + 1}', nn.Sequential(*blocks))

    @staticmethod
    def _check_inflate_style(block_type, inflate_style):
        if block_type == 'bottleneck' and inflate_style != '3x1x1':
            raise NotImplementedError(
                f'ResNet3d inflate_style={inflate_style!r} with Bottleneck '
                "blocks is not ported: the JAX ResNet3d gives its blocks "
                "'3x1x1' whatever the style, the reference passes it on")

    def _stem(self, in_channels, base_channels, conv1_kernel, conv1_stride_s,
              conv1_stride_t, pool1_stride_s, pool1_stride_t, with_pool1,
              dtype):
        """conv1 and pool1 (None without ``with_pool1``)."""
        k = tuple(conv1_kernel or self.conv1_kernel_default)
        self.conv1 = ConvModule(
            in_channels, base_channels, k,
            (conv1_stride_t, conv1_stride_s, conv1_stride_s),
            tuple((n - 1) // 2 for n in k), dtype=dtype)
        self.pool1 = nn.MaxPool3d(
            (1, 3, 3), (pool1_stride_t, pool1_stride_s, pool1_stride_s),
            (0, 1, 1)) if with_pool1 else None

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator):
        """``init_convs_bn``, then a non-local block's own init."""
        init_convs_bn(self, gen)
        for m in self.modules():
            if isinstance(m, NonLocal3d):
                m.init_weights(gen)

    def train(self, mode: bool = True):
        """``norm_eval``: the modules stay in eval mode (BN on its running
        statistics; a backbone has no dropout)."""
        super().train(mode)
        if self.norm_eval:
            for m in self.children():
                m.train(False)
        return self

    def _stage(self, x, i: int):
        """Stage i's blocks, each followed by its non-local block if it has
        one (``layer{i}_{b}_nonlocal``)."""
        for b, block in enumerate(getattr(self, f'layer{i + 1}')):
            x = block(x)
            nl = getattr(self, f'layer{i + 1}_{b}_nonlocal', None)
            if nl is not None:
                x = nl(x)
        return x

    def forward(self, x, laterals=None):
        x = self.conv1(x)
        if self.pool1 is not None:
            x = self.pool1(x)
        stem = x
        outs = []
        for i in range(self.num_stages):
            if laterals is not None and laterals[i] is not None:
                x = torch.cat([x, laterals[i]], dim=1)
            x = self._stage(x, i)
            if i == 0 and self.pool2 is not None:
                x = self.pool2(x)
            outs.append(x)
        outs = [outs[i] for i in self.out_indices]
        if self.return_stem:
            return stem, outs
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
        if any(any(s) if isinstance(s, (list, tuple)) else s
               for s in (kwargs.pop('non_local', None) or ())):
            raise NotImplementedError(
                'ResNet3dSlowOnly_TwoR5 non_local: the JAX module accepts '
                'it and builds no non-local block; leave it unset')
        # the JAX module asserts lateral is off and reads none of the rest
        for name, default in (('lateral', False), ('return_stem', False),
                              ('norm_eval', False), ('frozen_stages', -1),
                              ('with_cp', False)):
            _refuse('ResNet3dSlowOnly_TwoR5', name,
                    kwargs.get(name, default), default)
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


def _temporal_subsample(x, stride: int):
    """Frames 0, stride, 2 stride, ... of an NCTHW clip."""
    return x if stride <= 1 else x[:, :, ::stride]


@BACKBONES.register_module()
class ResNet3dSlowFast(nn.Module):
    """Two-pathway SlowFast (reference resnet3d_slowfast.py): the slow path
    sees every ``resample_rate``-th frame, the fast path every
    ``resample_rate // speed_ratio``-th. Both are ResNet3dSlowOnly pathways
    built from ``slow_pathway`` and ``fast_pathway`` (their ``type`` and
    ``pretrained`` dropped, ``with_pool2`` off and ``out_indices`` (0, 1,
    2, 3) unless given). With the slow path's ``lateral`` (default on),
    four bias-free (``fusion_kernel``,1,1) convs at stride
    (``speed_ratio``,1,1) to twice their input's channels (``lateral_{i}``,
    flax's default init) carry the fast path's post-pool stem and its
    stages 1-3 into the slow path, concatenated before its stages 1-4.
    Returns (the slow path's last stage, the fast path's), which
    ``SlowFastHead`` takes.

    The fast path is a ResNet3dSlowOnly as in the JAX module, so its
    ``inflate`` defaults to (0, 0, 1, 1), and the shipped configs give
    none; the reference's fast pathway inherits ResNet3d's (1, 1, 1, 1)
    (ROADMAP.md Queue 3). ``channel_ratio`` is accepted and not read: the
    fast path's width is its own ``base_channels``."""

    def __init__(self, pretrained=None, resample_rate: int = 8,
                 speed_ratio: int = 8, channel_ratio: int = 8,
                 slow_pathway=None, fast_pathway=None, dtype=None):
        super().__init__()
        dtype = compute_dtype.resolve_dtype(dtype)
        slow_cfg = dict(slow_pathway or dict(
            depth=50, lateral=True, conv1_kernel=(1, 7, 7),
            inflate=(0, 0, 1, 1)))
        fast_cfg = dict(fast_pathway or dict(
            depth=50, lateral=False, base_channels=8,
            conv1_kernel=(5, 7, 7), conv1_stride_t=1, pool1_stride_t=1))
        lateral = slow_cfg.pop('lateral', True)
        fk = int(slow_cfg.pop('fusion_kernel', 5))
        for cfg in (slow_cfg, fast_cfg):
            for key in ('type', 'pretrained', 'lateral', 'fusion_kernel'):
                cfg.pop(key, None)
            cfg.setdefault('with_pool2', False)
            cfg.setdefault('out_indices', (0, 1, 2, 3))
        self.resample_rate, self.speed_ratio = resample_rate, speed_ratio
        self.fast_path = ResNet3dSlowOnly(dtype=dtype, return_stem=True,
                                          **fast_cfg)
        base = fast_cfg.get('base_channels', 64)
        block_type = ARCH_SETTINGS[fast_cfg.get('depth', 50)][0]
        expansion = 1 if block_type == 'basic' else Bottleneck3d.expansion
        # the fast stem's channels, then its stages 1-3'
        srcs = [base] + [base * 2 ** i * expansion for i in range(3)]
        self.lateral = lateral
        if lateral:
            for i, c in enumerate(srcs):
                setattr(self, f'lateral_{i}', Conv3dNoBias(
                    c, 2 * c, (fk, 1, 1), (speed_ratio, 1, 1),
                    (fk // 2, 0, 0), dtype))
        self.slow_path = ResNet3dSlowOnly(
            dtype=dtype, lateral_inplanes=tuple(2 * c for c in srcs)
            if lateral else (0, 0, 0, 0), **slow_cfg)

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator):
        self.fast_path.init_weights(gen)
        if self.lateral:
            for i in range(4):
                lecun_normal_(getattr(self, f'lateral_{i}').weight, gen)
        self.slow_path.init_weights(gen)

    def _laterals(self, srcs):
        """The fusion convs on the fast path's stem and stages 1-3."""
        return [getattr(self, f'lateral_{i}')(src)
                for i, src in enumerate(srcs)]

    def forward(self, x):
        x_slow = _temporal_subsample(x, self.resample_rate)
        x_fast = _temporal_subsample(
            x, max(self.resample_rate // self.speed_ratio, 1))
        stem_fast, fast_outs = self.fast_path(x_fast)
        laterals = self._laterals([stem_fast] + list(fast_outs[:3])) \
            if self.lateral else None
        slow_outs = self.slow_path(x_slow, laterals)
        slow = slow_outs[-1] if isinstance(slow_outs, list) else slow_outs
        return slow, fast_outs[-1]


class _BN(nn.Module):
    """A BN alone under ``bn`` (the JAX tree's bare ``conv2_bn``, which
    ``convert.py`` maps to ``conv2.bn`` as in Bottleneck3d)."""

    def __init__(self, channels: int, dtype: torch.dtype):
        super().__init__()
        self.bn = make_bn(channels, dtype)

    def forward(self, x):
        return self.bn(x)


class CSNBottleneck(nn.Module):
    """The channel-separated bottleneck (reference resnet3d_csn.py:21-63):
    a 1x1x1 ConvBN-ReLU, in 'ip' mode a bias-free 1x1x1 conv
    (``conv2_ip``), the depthwise 3x3x3 conv at the block's stride
    (``conv2_dw``, groups = planes), BN-ReLU, a 1x1x1 ConvBN to 4x the
    planes; plus an identity or a 1x1x1 downsample."""
    expansion = 4

    def __init__(self, cin: int, planes: int, spatial_stride: int = 1,
                 temporal_stride: int = 1, mode: str = 'ir',
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        stride = (temporal_stride, spatial_stride, spatial_stride)
        out = planes * self.expansion
        self.conv1 = ConvModule(cin, planes, 1, dtype=dtype)
        self.conv2_ip = Conv3dNoBias(planes, planes, 1, 1, 0, dtype) \
            if mode == 'ip' else None
        self.conv2_dw = Conv3dNoBias(planes, planes, 3, stride, 1, dtype,
                                     groups=planes)
        self.conv2 = _BN(planes, dtype)
        self.conv3 = ConvModule(planes, out, 1, relu=False, dtype=dtype)
        self.downsample = None
        if stride != (1, 1, 1) or cin != out:
            self.downsample = ConvModule(cin, out, 1, stride, 0, relu=False,
                                         dtype=dtype)

    def forward(self, x):
        res = x if self.downsample is None else self.downsample(x)
        out = self.conv1(x)
        if self.conv2_ip is not None:
            out = self.conv2_ip(out)
        out = F.relu(self.conv2(self.conv2_dw(out)), inplace=True)
        return F.relu(self.conv3(out) + res, inplace=True)


@BACKBONES.register_module()
class ResNet3dCSN(ResNet3d):
    """Channel-separated networks, ir-CSN and ip-CSN (reference
    resnet3d_csn.py): ResNet3d's stem (conv1 (3,7,7) by default, pool1) and
    stages of ``CSNBottleneck`` (``bottleneck_mode`` 'ir' or 'ip'), depth
    50 or more. As in the JAX module: no pool2 whatever ``with_pool2``
    says; ``dilations``, ``inflate``, ``inflate_style`` (its default
    '3x3x3' is the depthwise conv's), ``non_local``, ``lateral``,
    ``return_stem``, ``frozen_stages`` and ``with_cp`` are accepted and not
    read; ``norm_eval`` or ``bn_frozen`` keeps every BN on its running
    statistics."""
    def __init__(self, depth: int = 152, pretrained=None, stage_blocks=None,
                 pretrained2d: bool = True, in_channels: int = 3,
                 num_stages: int = 4, base_channels: int = 64,
                 out_indices: Sequence[int] = (3,),
                 spatial_strides: Sequence[int] = (1, 2, 2, 2),
                 temporal_strides: Sequence[int] = (1, 1, 1, 1),
                 conv1_kernel=None, conv1_stride_s: int = 2,
                 conv1_stride_t: int = 1, pool1_stride_s: int = 2,
                 pool1_stride_t: int = 1, with_pool1: bool = True,
                 bottleneck_mode: str = 'ir', bn_frozen: bool = False,
                 norm_eval: bool = False, style: str = 'pytorch',
                 dilations=(1, 1, 1, 1), with_pool2: bool = False,
                 inflate=(1, 1, 1, 1), inflate_style: str = '3x3x3',
                 frozen_stages: int = -1, with_cp: bool = False,
                 non_local=(0, 0, 0, 0), non_local_cfg=None,
                 zero_init_residual: bool = True, lateral: bool = False,
                 return_stem: bool = False, conv_cfg=None, norm_cfg=None,
                 act_cfg=None, dtype=None):
        nn.Module.__init__(self)
        _refuse('ResNet3dCSN', 'style', style, 'pytorch')
        if bottleneck_mode not in ('ir', 'ip'):
            raise ValueError(f'ResNet3dCSN bottleneck_mode {bottleneck_mode!r}')
        block_type, default_blocks = ARCH_SETTINGS[depth]
        if block_type != 'bottleneck':
            raise ValueError('ResNet3dCSN requires depth >= 50')
        dtype = compute_dtype.resolve_dtype(dtype)
        stage_blocks = stage_blocks or default_blocks[:num_stages]
        self._stem(in_channels, base_channels, conv1_kernel, conv1_stride_s,
                   conv1_stride_t, pool1_stride_s, pool1_stride_t,
                   with_pool1, dtype)
        self.pool2 = None
        self.out_indices = tuple(out_indices)
        self.num_stages = len(stage_blocks)
        self.norm_eval = norm_eval or bn_frozen
        self.return_stem = False
        cin = base_channels
        for i, num_blocks in enumerate(stage_blocks):
            planes = base_channels * 2 ** i
            blocks = []
            for b in range(num_blocks):
                blocks.append(CSNBottleneck(
                    cin, planes, spatial_strides[i] if b == 0 else 1,
                    temporal_strides[i] if b == 0 else 1, bottleneck_mode,
                    dtype))
                cin = planes * CSNBottleneck.expansion
            setattr(self, f'layer{i + 1}', nn.Sequential(*blocks))


@BACKBONES.register_module()
class ResNet3dLayer(nn.Module):
    """One ResNet3d stage with no stem (reference resnet3d.py
    ResNet3dLayer, the AVA RoI head's shared extension): stage ``stage``
    (0-3) of the ``depth`` table, its input the previous stage's output
    (``base_channels`` for stage 0), the first block at
    (``temporal_stride``, ``spatial_stride``). ``all_frozen``: BN on its
    running statistics in training too, and the gradient stops at the
    output (``stop_gradient``: the parameters get zeros). As in the JAX
    module, ``norm_eval``, ``with_cp`` and ``zero_init_residual`` are
    accepted and not applied, and the blocks take '3x1x1' whatever
    ``inflate_style`` says."""

    def __init__(self, depth: int = 50, pretrained=None,
                 pretrained2d: bool = True, stage: int = 3,
                 base_channels: int = 64, spatial_stride: int = 2,
                 temporal_stride: int = 1, dilation: int = 1,
                 style: str = 'pytorch', all_frozen: bool = False,
                 inflate: int = 1, inflate_style: str = '3x1x1',
                 norm_eval: bool = False, with_cp: bool = False,
                 zero_init_residual: bool = True, conv_cfg=None,
                 norm_cfg=None, act_cfg=None, dtype=None):
        super().__init__()
        _refuse('ResNet3dLayer', 'style', style, 'pytorch')
        if not 0 <= stage <= 3:
            raise ValueError(f'ResNet3dLayer stage {stage}')
        dtype = compute_dtype.resolve_dtype(dtype)
        block_type, default_blocks = ARCH_SETTINGS[depth]
        block_cls = BasicBlock3d if block_type == 'basic' else Bottleneck3d
        planes = base_channels * 2 ** stage
        cin = base_channels * 2 ** (stage - 1) * block_cls.expansion \
            if stage else base_channels
        blocks = []
        for b in range(default_blocks[stage]):
            blocks.append(block_cls(
                cin, planes,
                spatial_stride=spatial_stride if b == 0 else 1,
                temporal_stride=temporal_stride if b == 0 else 1,
                dilation=dilation, inflate=bool(inflate), dtype=dtype))
            cin = planes * block_cls.expansion
        self.stage = stage
        setattr(self, f'layer{stage + 1}', nn.Sequential(*blocks))
        self.all_frozen = all_frozen

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator):
        init_convs_bn(self, gen)

    def train(self, mode: bool = True):
        super().train(mode)
        if self.all_frozen:
            for m in self.children():
                m.train(False)
        return self

    def forward(self, x):
        x = getattr(self, f'layer{self.stage + 1}')(x)
        return stop_gradient(x) if self.all_frozen else x
