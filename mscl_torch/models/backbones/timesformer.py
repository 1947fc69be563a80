"""TimeSformer, the divided space-time attention video transformer.

Port of ``mscl_tpu/models/backbones/timesformer.py`` (reference mmaction
backbones/timesformer.py): a ViT patch embedding of every frame, then
blocks of temporal attention (each patch over the frames) and spatial
attention (each frame's patches and the class token), 'divided_space_time';
'joint_space_time' attends over every token at once and 'space_only' over
each frame's tokens, with the frames in the batch. Attention is explicit
``q @ k^T``, softmax and ``@ v``, as the JAX module computes it.

The module names are the JAX tree's: ``patch_embed`` (a Conv2d with bias),
``pos_embed``, ``cls_token`` and ``time_embed`` (parameters),
``block_{i}`` with ``norm_t``, ``temporal_attn`` (``qkv``, ``proj``),
``temporal_fc``, ``norm_s``, ``spatial_attn``, ``norm1`` and ``attn``
(joint and space-only), ``mlp`` (``fc1``, ``fc2``) and ``norm2``; then
``norm``. Two of flax's defaults kept: LayerNorm's epsilon is 1e-6 (torch's
is 1e-5) and GELU is the exact one (torch's default). Inits as flax's:
lecun-normal Dense and conv kernels with zero biases, LayerNorm 1/0,
``pos_embed`` and ``time_embed`` normal(0.02), ``cls_token`` zeros.

The JAX module sizes ``pos_embed`` and ``time_embed`` from its first input;
torch sizes them when it is built, from ``img_size``, ``patch_size`` and
``num_frames``, and a clip of another size is refused by name.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .. import compute_dtype
from ..builder import BACKBONES
from ..weight_init import lecun_normal_

LN_EPS = 1e-6                  # flax's LayerNorm epsilon


class LayerNorm(nn.LayerNorm):
    """flax's LayerNorm (epsilon 1e-6) in the compute dtype: the statistics
    in float32 or wider, the result cast to ``dtype``."""

    def __init__(self, dim: int, dtype: torch.dtype = torch.float32):
        super().__init__(dim, eps=LN_EPS)
        self.compute_dtype = dtype

    def forward(self, x):
        wide = x if x.dtype in (torch.float32, torch.float64) else x.float()
        y = F.layer_norm(wide, self.normalized_shape,
                         self.weight.to(wide.dtype), self.bias.to(wide.dtype),
                         self.eps)
        return y.to(self.compute_dtype) \
            if self.compute_dtype != torch.float32 else y


class MHSA(nn.Module):
    """Multi-head self-attention: ``qkv`` (one Dense to 3 dim), the logits
    over sqrt(head width), softmax, ``proj``."""

    def __init__(self, dim: int, num_heads: int = 12,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads, self.dtype = num_heads, dtype
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        b, n, c = x.shape
        h = self.num_heads
        qkv = compute_dtype.linear(self.qkv, x, self.dtype)
        q, k, v = qkv.reshape(b, n, 3, h, c // h).permute(
            2, 0, 3, 1, 4).unbind(0)                 # each (b, h, n, d)
        attn = (q @ k.transpose(-2, -1)).float() if self.dtype not in (
            torch.float32, torch.float64) else q @ k.transpose(-2, -1)
        attn = torch.softmax(attn / (c // h) ** 0.5, dim=-1).to(v.dtype)
        out = (attn @ v).transpose(1, 2).reshape(b, n, c)
        return compute_dtype.linear(self.proj, out, self.dtype)


class Mlp(nn.Module):
    """``fc1`` to ``mlp_ratio`` times the width, exact GELU, ``fc2``."""

    def __init__(self, dim: int, mlp_ratio: float = 4.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.fc1 = nn.Linear(dim, int(dim * mlp_ratio))
        self.fc2 = nn.Linear(int(dim * mlp_ratio), dim)

    def forward(self, x):
        x = F.gelu(compute_dtype.linear(self.fc1, x, self.dtype))
        return compute_dtype.linear(self.fc2, x, self.dtype)


class DividedBlock(nn.Module):
    """A block over (B, 1 + T P, C) tokens, the class token first.
    'divided_space_time': temporal attention of each patch over the frames
    (``norm_t``, ``temporal_attn``, ``temporal_fc``, residual), then
    spatial attention of each frame's patches with the class token
    (``norm_s``, ``spatial_attn``; the class token's outputs averaged over
    the frames, residual); otherwise one attention over every token
    (``norm1``, ``attn``, residual). Then ``mlp`` after ``norm2``,
    residual."""

    def __init__(self, dim: int, num_heads: int, num_frames: int,
                 attention_type: str = 'divided_space_time',
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_frames, self.attention_type = num_frames, attention_type
        self.dtype = dtype
        if attention_type == 'divided_space_time':
            self.norm_t = LayerNorm(dim, dtype)
            self.temporal_attn = MHSA(dim, num_heads, dtype)
            self.temporal_fc = nn.Linear(dim, dim)
            self.norm_s = LayerNorm(dim, dtype)
            self.spatial_attn = MHSA(dim, num_heads, dtype)
        else:
            self.norm1 = LayerNorm(dim, dtype)
            self.attn = MHSA(dim, num_heads, dtype)
        self.mlp = Mlp(dim, dtype=dtype)
        self.norm2 = LayerNorm(dim, dtype)

    def _temporal(self, xt):
        """Temporal attention of each patch over the frames, (B P, T, C)."""
        return self.temporal_attn(self.norm_t(xt))

    def forward(self, x):
        b, n, c = x.shape
        t = self.num_frames
        p = (n - 1) // t
        if self.attention_type == 'divided_space_time':
            xt = x[:, 1:].reshape(b, t, p, c).transpose(1, 2).reshape(
                b * p, t, c)
            xt = xt + compute_dtype.linear(self.temporal_fc,
                                           self._temporal(xt), self.dtype)
            xt = xt.reshape(b, p, t, c).transpose(1, 2).reshape(b, t * p, c)
            x = torch.cat([x[:, :1], xt], dim=1)
            xs = x[:, 1:].reshape(b * t, p, c)
            cls = x[:, :1].repeat_interleave(t, dim=0)
            res_s = self.spatial_attn(self.norm_s(torch.cat([cls, xs], 1)))
            cls_out = res_s[:, 0].reshape(b, t, c).mean(dim=1, keepdim=True)
            x = x + torch.cat([cls_out, res_s[:, 1:].reshape(b, t * p, c)],
                              dim=1)
        else:
            x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


@BACKBONES.register_module()
class TimeSformer(nn.Module):
    """(N, C, T, H, W) clips -> (N, embed_dims), the class token's feature
    after ``num_transformer_layers`` blocks and ``norm`` (space_only: the
    mean of each frame's). ``transformer_layers`` and ``norm_cfg`` are
    accepted and, as in the JAX module, not read; ``dropout_ratio`` is
    not applied there either."""

    def __init__(self, num_frames: int = 8, img_size: int = 224,
                 patch_size: int = 16, pretrained=None,
                 embed_dims: int = 768, num_heads: int = 12,
                 num_transformer_layers: int = 12,
                 attention_type: str = 'divided_space_time',
                 dropout_ratio: float = 0.0, in_channels: int = 3,
                 transformer_layers=None, norm_cfg=None, dtype=None):
        super().__init__()
        if attention_type not in ('divided_space_time', 'joint_space_time',
                                  'space_only'):
            raise ValueError(f'TimeSformer attention_type {attention_type!r}')
        self.dtype = compute_dtype.resolve_dtype(dtype)
        self.num_frames, self.patch_size = num_frames, patch_size
        self.img_size, self.attention_type = img_size, attention_type
        self.embed_dims = embed_dims
        p = (img_size // patch_size) ** 2
        self.patch_embed = nn.Conv2d(in_channels, embed_dims, patch_size,
                                     patch_size)
        self.pos_embed = nn.Parameter(torch.zeros(1, p + 1, embed_dims))
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dims))
        if attention_type != 'space_only':
            self.time_embed = nn.Parameter(torch.zeros(1, num_frames,
                                                       embed_dims))
        frames = 1 if attention_type == 'space_only' else num_frames
        self.num_layers = num_transformer_layers
        for i in range(num_transformer_layers):
            setattr(self, f'block_{i}', DividedBlock(
                embed_dims, num_heads, frames, attention_type, self.dtype))
        self.norm = LayerNorm(embed_dims, self.dtype)

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator):
        for m in self.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d)):
                lecun_normal_(m.weight, gen)
                m.bias.zero_()
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
        nn.init.normal_(self.pos_embed, 0.0, 0.02, generator=gen)
        self.cls_token.zero_()
        if self.attention_type != 'space_only':
            nn.init.normal_(self.time_embed, 0.0, 0.02, generator=gen)

    def forward(self, x):
        b, c, t, h, w = x.shape
        if t != self.num_frames or (h, w) != (self.img_size,) * 2:
            raise ValueError(
                f'TimeSformer built for {self.num_frames} frames of '
                f'{self.img_size}x{self.img_size} (num_frames, img_size); '
                f'got {t} of {h}x{w}')
        d = self.embed_dims
        x = x.transpose(1, 2).reshape(b * t, c, h, w)
        x = compute_dtype.conv(self.patch_embed, x, self.dtype)
        x = x.flatten(2).transpose(1, 2)                   # (b t, p, d)
        p = x.shape[1]
        x = (torch.cat([self.cls_token.expand(b * t, 1, d).to(x.dtype), x],
                       dim=1) + self.pos_embed).to(self.dtype)
        if self.attention_type != 'space_only':
            patches = (x[:, 1:].reshape(b, t, p, d) +
                       self.time_embed[:, :, None]).to(self.dtype)
            x = torch.cat([x[:, :1].reshape(b, t, 1, d)[:, 0],
                           patches.reshape(b, t * p, d)], dim=1)
        for i in range(self.num_layers):
            x = getattr(self, f'block_{i}')(x)
        x = self.norm(x)
        if self.attention_type == 'space_only':
            return x[:, 0].reshape(b, t, d).mean(dim=1)
        return x[:, 0]
