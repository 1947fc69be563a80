"""MoCo necks: pooled global embedding plus multi-level features.

Port of ``mscl_tpu/models/necks/base_moco.py``: ``BaseMoCo``,
``MixBaseMoCo`` (the embedding appended to the features), ``TPNMoCo``
(with emb_from_bkb=True), ``TPNProjMoCo`` and ``TPNProjMoCoV2`` (per-level
1x1x1 projections that fold channel groups into time) and
``BaseMoCo_TwoR5`` (a last stage of (global, local) features).
All return (x_emb (N, C), feature list); with ``mlvl=False`` the list is
None and no pyramid or projection runs (the key towers, whose features
nothing reads). ``dtype`` is the compute dtype of the pyramid and the
projections; the pooled embedding keeps its input's dtype.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .. import compute_dtype
from ..builder import NECKS
from .fpn_video import TPNSingle


def gap3d(x: torch.Tensor) -> torch.Tensor:
    """AdaptiveAvgPool3d(1) + flatten over NCTHW."""
    return x.mean(dim=(2, 3, 4))


@NECKS.register_module()
class BaseMoCo(nn.Module):

    def __init__(self, dtype=None):
        super().__init__()

    def init_weights(self, gen: torch.Generator):
        pass

    def forward(self, x, mlvl: bool = True):
        return gap3d(x[-1]), list(x) if mlvl else None


@NECKS.register_module()
class MixBaseMoCo(BaseMoCo):
    """BaseMoCo with the embedding appended as the last feature."""

    def forward(self, x, mlvl: bool = True):
        x_emb = gap3d(x[-1])
        return x_emb, list(x) + [x_emb] if mlvl else None


@NECKS.register_module()
class BaseMoCo_TwoR5(BaseMoCo):
    """The last stage is a (global, local) pair: the embedding pooled from
    the global one, the local one passed on as the last feature."""

    def forward(self, x, mlvl: bool = True):
        last = x[-1] if isinstance(x, (list, tuple)) else None
        if not (isinstance(last, (list, tuple)) and len(last) == 2):
            # JAX's neck unpacks whatever comes last: given the bare pair
            # (the backbone's default out_indices=(3,)) it splits the local
            # feature along its batch axis
            raise ValueError(
                'BaseMoCo_TwoR5 takes a backbone output whose last element '
                'is the (global, local) pair of ResNet3dSlowOnly_TwoR5; give '
                'the backbone out_indices with its last stage and at least '
                'one other')
        x_g, x_l = last
        return gap3d(x_g), list(x[:-1]) + [x_l] if mlvl else None


@NECKS.register_module()
class TPNMoCo(nn.Module):
    """TPNSingle pyramid; the embedding is pooled from the backbone's last
    stage (the JAX neck's emb_from_bkb=True, the only form MSCL uses)."""

    def __init__(self, in_channels: Sequence[int] = (128, 256, 512),
                 out_channels: int = 128, fpn_cfg=None,
                 temporal_modulation_cfg=None, sepc_cfg=None,
                 reverse_st: bool = False, dtype=None):
        super().__init__()
        self.tpn = TPNSingle(list(in_channels), out_channels, fpn_cfg=fpn_cfg,
                             temporal_modulation_cfg=temporal_modulation_cfg,
                             sepc_cfg=sepc_cfg, reverse_st=reverse_st,
                             dtype=dtype)

    def init_weights(self, gen: torch.Generator):
        self.tpn.init_weights(gen)

    def forward(self, x, mlvl: bool = True):
        return gap3d(x[-1]), self.tpn(x) if mlvl else None


@NECKS.register_module()
class TPNProjMoCoV2(nn.Module):
    """For each level of ``ft_ids``: the first 1/chunks[i] of its channels,
    an adaptive temporal average pool to temporal_sizes[i], a 1x1x1 conv
    to dims_in[i] // 2, ReLU, a 1x1x1 conv to dims_out[i] * r and the r
    channel groups unfolded into time (r = temporal_sizes[0] //
    temporal_sizes[i]), so every level leaves with temporal_sizes[0]
    frames. The convs are flax's ``proj{i}_0`` / ``proj{i}_1`` (lecun-normal
    weights, zero bias)."""

    def __init__(self, dims_in: Sequence[int] = (128, 256, 512),
                 dims_out: Sequence[int] = (128, 128, 128),
                 ft_ids: Sequence[int] = (0, 1, 2),
                 temporal_sizes: Sequence[int] = (4, 2, 1),
                 chunks: Sequence[int] = (1, 2, 2), dtype=None):
        super().__init__()
        self.dtype = compute_dtype.resolve_dtype(dtype)
        self.ft_ids = tuple(ft_ids)
        self.temporal_sizes = tuple(temporal_sizes)
        self.chunks = tuple(chunks)
        self.rates = [temporal_sizes[0] // sz for sz in temporal_sizes]
        for i in self.ft_ids:
            mid = dims_in[i] // 2
            setattr(self, f'proj{i}_0', nn.Conv3d(
                dims_in[i] // self.chunks[i], mid, 1))
            setattr(self, f'proj{i}_1', nn.Conv3d(
                mid, dims_out[i] * self.rates[i], 1))

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator):
        for m in self.modules():
            if isinstance(m, nn.Conv3d):
                std = math.sqrt(1.0 / m.weight[0].numel()) / \
                    .87962566103423978
                nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std,
                                      generator=gen)
                m.bias.zero_()

    def forward(self, x, mlvl: bool = True):
        x_emb = gap3d(x[-1])
        if not mlvl:
            return x_emb, None
        num_out = len(self.ft_ids)
        new_x = []
        for i in self.ft_ids:
            cur = x[i - num_out]
            cur = cur[:, :cur.shape[1] // self.chunks[i]]
            n, c, t, h, w = cur.shape
            sz = self.temporal_sizes[i]
            if t != sz:
                cur = cur.reshape(n, c, sz, t // sz, h, w).mean(dim=3)
            cur = F.relu(compute_dtype.conv3d(getattr(self, f'proj{i}_0'),
                                              cur, self.dtype))
            cur = compute_dtype.conv3d(getattr(self, f'proj{i}_1'), cur,
                                       self.dtype)
            n, rc, t, h, w = cur.shape
            r = self.rates[i]
            # channel group g of r goes to frame t * r + g
            cur = cur.reshape(n, r, rc // r, t, h, w).permute(0, 2, 3, 1, 4, 5)
            new_x.append(cur.reshape(n, rc // r, t * r, h, w))
        return x_emb, new_x


@NECKS.register_module()
class TPNProjMoCo(TPNProjMoCoV2):
    """TPNProjMoCoV2 over every level and all of its channels."""

    def __init__(self, dims_in: Sequence[int] = (128, 256, 512),
                 dims_out: Sequence[int] = (128, 128, 128),
                 temporal_sizes: Sequence[int] = (4, 2, 1), dtype=None):
        super().__init__(dims_in, dims_out, tuple(range(len(dims_in))),
                         temporal_sizes, (1,) * len(dims_in), dtype)
