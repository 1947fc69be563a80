"""The 2D backbones the TSN ``custom_backbones`` configs name from
torchvision, mmcls and timm, written out here: ResNeXt, DenseNet and the
Swin transformer.

Port of ``mscl_tpu/models/backbones/extern_2d.py``. Each takes frames
(N * segments, C, H, W) and returns NCHW: ResNeXt the stages of
``out_indices``, DenseNet ``norm5``'s map after its ReLU, Swin the last
stage's tokens after ``norm`` as (N, 1024, H/32, W/32) (the JAX module
returns them NHWC), so that ``TSNHead`` pools each unchanged. Each is
registered under its own name and under the external name its config
gives (``mmcls.ResNeXt``, ``torchvision.densenet161``,
``timm.swin_base_patch4_window7_224``). ``pretrained`` names a download
and is dropped by the recognizer; no weights are fetched.

- ``ResNeXt``: a 7x7 stem and a 3x3 max-pool, then ``BottleneckX``
  blocks: 1x1, a grouped 3x3 (``groups``, width planes x
  ``width_per_group`` x ``groups`` / 64), 1x1; ``ARCH_NEXT`` gives the
  blocks a stage. ``norm_eval`` keeps BN on its running statistics while
  training. ``style``, ``frozen_stages`` and ``norm_cfg`` are accepted and
  not applied, as the JAX module accepts them: the convs sit as
  torchvision's, every stage learns, BN is fixed.
- ``DenseNet``: ``DenseLayer``s (BN-ReLU-1x1 to ``bn_size`` x growth,
  BN-ReLU-3x3 to growth, the result concatenated after its input), a
  transition after each block but the last (BN-ReLU-1x1 to half the
  channels, a 2x2 average pool), then ``norm5`` and a ReLU. The defaults
  are DenseNet-161's.
- ``SwinTransformer``: a patch embedding (a conv of stride ``patch_size``
  padded as flax's 'SAME', with a bias) and its LayerNorm, then stages of
  ``SwinBlock``s, ``PatchMerging`` between them. A block works on
  channels-last tokens (N, H, W, C): LayerNorm, the map padded to
  multiples of the window, rolled back by half a window in every other
  block, cut into windows, multi-head attention with a relative position
  bias (and, shifted, the -100 mask of pairs from different regions, per
  window, over every head), the windows merged, rolled forward, cropped,
  the residual; then LayerNorm, an MLP with the exact GELU, the residual.
  The window is ``min(window, h, w)`` and the shift is skipped when one
  window holds the map, so the bias table ((2 ws - 1)^2, heads) of a
  block depends on its input's size: torch sizes each from ``img_size``
  when it is built, and a block given a map whose window differs refuses
  it by name. Attention is explicit ``q @ k^T``, bias, softmax in float32
  and ``@ v``, as the JAX module computes it. flax's defaults kept:
  LayerNorm's epsilon 1e-6, bias-free ``reduction``.

Module names are the JAX tree's, so ``mscl_torch/convert.py`` maps it
mechanically: ``conv1`` (``conv``, ``bn``) and ``layer{i}.{b}``
(``conv1``, ``conv2``, ``bn2``, ``conv3``, ``downsample``); ``conv0``,
``norm0``, ``block{i}_layer{j}`` (``norm1``, ``conv1``, ``norm2``,
``conv2``), ``transition{i}_norm`` / ``_conv``, ``norm5``;
``patch_embed``, ``patch_norm``, ``stage{i}_block{b}`` (``norm1``,
``qkv``, ``relative_position_bias_table``, ``proj``, ``norm2``, ``fc1``,
``fc2``), ``merge{i}`` (``norm``, ``reduction``) and ``norm``. The inits
are the JAX package's: kaiming-normal fan_out convs and BN 1/0 for the
CNNs; lecun-normal Dense and conv kernels with zero biases, LayerNorm
1/0 and the bias tables truncated normal(0.02) for Swin.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import compute_dtype
from ..builder import BACKBONES
from ..weight_init import _TRUNCATED_STD, lecun_normal_
from ...ops.batch_norm import BatchNorm3d
from .resnet2d import Conv2d, ConvBN2d
from .resnet3d import init_convs_bn
from .timesformer import LayerNorm
from .video_resnet import make_bn

ARCH_NEXT = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}


class BottleneckX(nn.Module):
    """ResNeXt's bottleneck: ``conv1`` 1x1, the grouped 3x3 ``conv2`` and
    ``bn2``, ``conv3`` 1x1; the residual through ``downsample`` where the
    shape changes."""

    def __init__(self, cin: int, planes: int, stride: int = 1,
                 downsample: bool = False, groups: int = 32,
                 width_per_group: int = 4,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        width = int(planes * width_per_group * groups / 64.)
        self.conv1 = ConvBN2d(cin, width, 1, 1, 0, dtype=dtype)
        self.conv2 = Conv2d(width, width, 3, stride, 1, groups=groups,
                            bias=False, dtype=dtype)
        self.bn2 = make_bn(width, dtype)
        self.conv3 = ConvBN2d(width, planes * 4, 1, 1, 0, relu=False,
                              dtype=dtype)
        self.downsample = ConvBN2d(cin, planes * 4, 1, stride, 0, relu=False,
                                   dtype=dtype) if downsample else None

    def forward(self, x):
        y = F.relu(self.bn2(self.conv2(self.conv1(x))))
        y = self.conv3(y)
        return F.relu(y + (x if self.downsample is None
                           else self.downsample(x)))


@BACKBONES.register_module()
@BACKBONES.register_module(name='mmcls.ResNeXt')
class ResNeXt(nn.Module):
    """ResNeXt over (N * T, 3, H, W) frames (mmcls.ResNeXt)."""

    def __init__(self, depth: int = 101, num_stages: int = 4,
                 out_indices: Sequence[int] = (3,),
                 strides: Sequence[int] = (1, 2, 2, 2), groups: int = 32,
                 width_per_group: int = 4, style: str = 'pytorch',
                 frozen_stages: int = -1, norm_eval: bool = False,
                 norm_cfg=None, pretrained=None, dtype=None):
        super().__init__()
        dtype = compute_dtype.resolve_dtype(dtype)
        self.norm_eval, self.num_stages = norm_eval, num_stages
        self.out_indices = tuple(out_indices)
        blocks = ARCH_NEXT[depth]
        self.conv1 = ConvBN2d(3, 64, 7, 2, 3, dtype=dtype)
        cin = 64
        for i in range(num_stages):
            planes = 64 * 2 ** i
            layer = []
            for b in range(blocks[i]):
                stride = strides[i] if b == 0 else 1
                layer.append(BottleneckX(
                    cin, planes, stride,
                    b == 0 and (stride != 1 or cin != planes * 4),
                    groups, width_per_group, dtype))
                cin = planes * 4
            setattr(self, f'layer{i + 1}', nn.Sequential(*layer))

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator):
        init_convs_bn(self, gen)

    def train(self, mode: bool = True):
        """``norm_eval``: BN keeps its running statistics in training."""
        super().train(mode)
        if mode and self.norm_eval:
            for m in self.modules():
                if isinstance(m, BatchNorm3d):
                    m.eval()
        return self

    def forward(self, x):
        x = F.max_pool2d(self.conv1(x), 3, 2, 1)
        outs = []
        for i in range(self.num_stages):
            x = getattr(self, f'layer{i + 1}')(x)
            outs.append(x)
        outs = [outs[i] for i in self.out_indices]
        return outs[0] if len(outs) == 1 else outs


class DenseLayer(nn.Module):
    """BN-ReLU-1x1 (``norm1``, ``conv1``) to ``bn_size`` x growth, BN-ReLU-3x3
    (``norm2``, ``conv2``) to growth; returns [x, y] along the channels."""

    def __init__(self, cin: int, growth_rate: int, bn_size: int = 4,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        mid = bn_size * growth_rate
        self.norm1 = make_bn(cin, dtype)
        self.conv1 = Conv2d(cin, mid, 1, bias=False, dtype=dtype)
        self.norm2 = make_bn(mid, dtype)
        self.conv2 = Conv2d(mid, growth_rate, 3, 1, 1, bias=False,
                            dtype=dtype)

    def forward(self, x):
        y = self.conv1(F.relu(self.norm1(x)))
        y = self.conv2(F.relu(self.norm2(y)))
        return torch.cat([x, y], dim=1)


@BACKBONES.register_module(name='torchvision.densenet161')
@BACKBONES.register_module()
class DenseNet(nn.Module):
    """DenseNet over (N * T, 3, H, W) frames; the defaults are DenseNet-161's
    (96 initial features, growth 48, blocks (6, 12, 36, 24): 2208
    channels)."""

    def __init__(self, num_init_features: int = 96, growth_rate: int = 48,
                 block_config: Sequence[int] = (6, 12, 36, 24),
                 bn_size: int = 4, pretrained=None, dtype=None):
        super().__init__()
        dtype = compute_dtype.resolve_dtype(dtype)
        self.block_config = tuple(block_config)
        self.conv0 = Conv2d(3, num_init_features, 7, 2, 3, bias=False,
                            dtype=dtype)
        self.norm0 = make_bn(num_init_features, dtype)
        feats = num_init_features
        for i, layers in enumerate(self.block_config):
            for j in range(layers):
                setattr(self, f'block{i + 1}_layer{j + 1}', DenseLayer(
                    feats + j * growth_rate, growth_rate, bn_size, dtype))
            feats += layers * growth_rate
            if i != len(self.block_config) - 1:
                setattr(self, f'transition{i + 1}_norm', make_bn(feats, dtype))
                setattr(self, f'transition{i + 1}_conv', Conv2d(
                    feats, feats // 2, 1, bias=False, dtype=dtype))
                feats //= 2
        self.norm5 = make_bn(feats, dtype)
        self.out_channels = feats

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator):
        init_convs_bn(self, gen)

    def forward(self, x):
        x = F.max_pool2d(F.relu(self.norm0(self.conv0(x))), 3, 2, 1)
        for i, layers in enumerate(self.block_config):
            for j in range(layers):
                x = getattr(self, f'block{i + 1}_layer{j + 1}')(x)
            if i != len(self.block_config) - 1:
                x = F.relu(getattr(self, f'transition{i + 1}_norm')(x))
                x = getattr(self, f'transition{i + 1}_conv')(x)
                x = F.avg_pool2d(x, 2, 2)
        return F.relu(self.norm5(x))


# ------------------------------------------------------------------- Swin
def _rel_position_index(ws: int) -> np.ndarray:
    """(ws*ws, ws*ws) index into the (2ws-1)^2 relative-bias table
    (timm swin_transformer.get_relative_position_index)."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws),
                                  indexing='ij'))          # (2, ws, ws)
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]              # (2, L, L)
    rel = rel.transpose(1, 2, 0) + (ws - 1)
    return rel[..., 0] * (2 * ws - 1) + rel[..., 1]


def _shift_attn_mask(hp: int, wp: int, ws: int, shift: int) -> np.ndarray:
    """(nW, L, L) additive attention mask for shifted windows (timm
    WindowAttention mask: cross-region pairs get -100)."""
    img = np.zeros((hp, wp))
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for vs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[hs, vs] = cnt
            cnt += 1
    win = img.reshape(hp // ws, ws, wp // ws, ws)
    win = win.transpose(0, 2, 1, 3).reshape(-1, ws * ws)   # (nW, L)
    mask = win[:, None, :] - win[:, :, None]
    return np.where(mask != 0, -100.0, 0.0).astype(np.float32)


def _pair(v) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


class SwinBlock(nn.Module):
    """One Swin block over (N, H, W, C) tokens (timm SwinTransformerBlock):
    (shifted-)window attention with a relative position bias, then the
    MLP, each after a LayerNorm and with a residual. ``input_hw`` is the
    (H, W) it is built for, which sizes the bias table."""

    def __init__(self, dim: int, num_heads: int, window: int = 7,
                 shift: bool = False, mlp_ratio: float = 4.0,
                 input_hw=(56, 56), dtype: torch.dtype = torch.float32):
        super().__init__()
        h, w = _pair(input_hw)
        self.num_heads, self.window, self.shift = num_heads, window, shift
        self.dtype = dtype
        self.ws = min(window, h, w)
        self.norm1 = LayerNorm(dim, dtype)
        self.qkv = nn.Linear(dim, 3 * dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * self.ws - 1) ** 2, num_heads))
        self.proj = nn.Linear(dim, dim)
        self.norm2 = LayerNorm(dim, dtype)
        self.fc1 = nn.Linear(dim, int(dim * mlp_ratio))
        self.fc2 = nn.Linear(int(dim * mlp_ratio), dim)
        self._consts: Dict[tuple, torch.Tensor] = {}

    def _const(self, key, make, device):
        """A constant of the attention (the bias index, the shift mask),
        made in numpy once a shape and device."""
        key = key + (str(device),)
        if key not in self._consts:
            self._consts[key] = torch.from_numpy(make()).to(device)
        return self._consts[key]

    def _attention(self, y, n: int, hp: int, wp: int, ws: int, shift: int):
        """Window attention over (n * nW, L, C) windows."""
        heads, c = self.num_heads, y.shape[-1]
        hd, L = c // heads, ws * ws
        qkv = compute_dtype.linear(self.qkv, y, self.dtype)
        q, k, v = qkv.reshape(-1, L, 3, heads, hd).permute(
            2, 0, 3, 1, 4).unbind(0)                 # each (B', heads, L, hd)
        attn = (q * hd ** -0.5) @ k.transpose(-2, -1)
        idx = self._const(('index', ws), lambda: _rel_position_index(ws),
                          y.device)
        bias = self.relative_position_bias_table[idx.reshape(-1)]
        attn = attn + bias.reshape(L, L, heads).permute(2, 0, 1)[None] \
            .to(attn.dtype)
        if shift:
            mask = self._const(('mask', hp, wp, ws, shift),
                               lambda: _shift_attn_mask(hp, wp, ws, shift),
                               y.device)
            attn = (attn.reshape(n, -1, heads, L, L) +
                    mask[None, :, None].to(attn.dtype)).reshape(-1, heads, L, L)
        wide = attn if attn.dtype == torch.float64 else attn.float()
        attn = torch.softmax(wide, dim=-1).to(v.dtype)
        y = (attn @ v).transpose(1, 2).reshape(-1, L, c)
        return compute_dtype.linear(self.proj, y, self.dtype)

    def forward(self, x):
        n, h, w, c = x.shape
        ws = min(self.window, h, w)
        if ws != self.ws:
            raise ValueError(
                f'SwinBlock built for a window of {self.ws} (input_hw, '
                f'the SwinTransformer\'s img_size); a {h}x{w} map takes '
                f'{ws}')
        # timm: when the input fits in one window, shifting is a no-op
        shift = ws // 2 if (self.shift and (h > ws or w > ws)) else 0
        hp, wp = -(-h // ws) * ws, -(-w // ws) * ws
        y = F.pad(self.norm1(x), (0, 0, 0, wp - w, 0, hp - h))
        if shift:
            y = torch.roll(y, (-shift, -shift), (1, 2))
        nwh, nww = hp // ws, wp // ws
        y = y.reshape(n, nwh, ws, nww, ws, c).permute(
            0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, c)
        y = self._attention(y, n, hp, wp, ws, shift)
        y = y.reshape(n, nwh, nww, ws, ws, c).permute(
            0, 1, 3, 2, 4, 5).reshape(n, hp, wp, c)
        if shift:
            y = torch.roll(y, (shift, shift), (1, 2))
        x = x + y[:, :h, :w]
        y = F.gelu(compute_dtype.linear(self.fc1, self.norm2(x), self.dtype))
        return x + compute_dtype.linear(self.fc2, y, self.dtype)


class PatchMerging(nn.Module):
    """(N, H, W, C) -> (N, ceil(H/2), ceil(W/2), 2C): each 2x2
    neighbourhood's four tokens concatenated, (0, 0), (1, 0), (0, 1),
    (1, 1), an odd size padded with zeros; ``norm``, then the bias-free
    ``reduction``."""

    def __init__(self, dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.norm = LayerNorm(4 * dim, dtype)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x):
        h, w = x.shape[1:3]
        x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2],
                       x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1)
        return compute_dtype.linear(self.reduction, self.norm(x), self.dtype)


@BACKBONES.register_module(name='timm.swin_base_patch4_window7_224')
@BACKBONES.register_module()
class SwinTransformer(nn.Module):
    """Swin over (N * T, 3, H, W) frames; the defaults are Swin-B's (patch
    4, window 7, embed 128, depths (2, 2, 18, 2), heads (4, 8, 16, 32)).
    ``img_size`` sizes each block's bias table (a map of another size is
    refused by the first block whose window it changes; any size of at
    least 224 gives Swin-B's windows of 7)."""

    def __init__(self, patch_size: int = 4, window: int = 7,
                 embed_dim: int = 128, depths: Sequence[int] = (2, 2, 18, 2),
                 num_heads: Sequence[int] = (4, 8, 16, 32),
                 mlp_ratio: float = 4.0, img_size=224, pretrained=None,
                 dtype=None):
        super().__init__()
        self.dtype = compute_dtype.resolve_dtype(dtype)
        self.patch_size, self.depths = patch_size, tuple(depths)
        self.patch_embed = nn.Conv2d(3, embed_dim, patch_size, patch_size)
        self.patch_norm = LayerNorm(embed_dim, self.dtype)
        h, w = (-(-s // patch_size) for s in _pair(img_size))
        dim = embed_dim
        for i, depth in enumerate(self.depths):
            if i > 0:
                setattr(self, f'merge{i}', PatchMerging(dim, self.dtype))
                dim, h, w = 2 * dim, -(-h // 2), -(-w // 2)
            for b in range(depth):
                setattr(self, f'stage{i + 1}_block{b}', SwinBlock(
                    dim, num_heads[i], window, bool(b % 2), mlp_ratio,
                    (h, w), self.dtype))
        self.norm = LayerNorm(dim, self.dtype)
        self.out_channels = dim

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator):
        for m in self.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d)):
                lecun_normal_(m.weight, gen)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, SwinBlock):
                std = 0.02 / _TRUNCATED_STD
                nn.init.trunc_normal_(m.relative_position_bias_table, 0.0,
                                      std, -2 * std, 2 * std, generator=gen)

    def _embed(self, x):
        """The patch conv with flax's 'SAME' padding (zeros at the end when
        a side is not a multiple of the patch)."""
        p = self.patch_size
        h, w = x.shape[-2:]
        pad_h, pad_w = -h % p, -w % p
        x = F.pad(x, (pad_w // 2, pad_w - pad_w // 2,
                      pad_h // 2, pad_h - pad_h // 2))
        return compute_dtype.conv(self.patch_embed, x, self.dtype)

    def forward(self, x):
        x = self.patch_norm(self._embed(x).permute(0, 2, 3, 1))
        for i, depth in enumerate(self.depths):
            if i > 0:
                x = getattr(self, f'merge{i}')(x)
            for b in range(depth):
                x = getattr(self, f'stage{i + 1}_block{b}')(x)
        return self.norm(x).permute(0, 3, 1, 2)


__all__ = ['ARCH_NEXT', 'BottleneckX', 'ResNeXt', 'DenseLayer', 'DenseNet',
           'SwinBlock', 'PatchMerging', 'SwinTransformer']

