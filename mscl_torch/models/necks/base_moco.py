"""MoCo necks: pooled global embedding plus multi-level features.

Port of ``mscl_tpu/models/necks/base_moco.py`` ``BaseMoCo`` and ``TPNMoCo``
(with emb_from_bkb=True).
Both return (x_emb (N, C), feature list); with ``mlvl=False`` the list is
None and TPNMoCo does not run its pyramid (the key towers, whose features
nothing reads). ``dtype`` is the compute dtype of TPNMoCo's pyramid; the
pooled embedding keeps its input's dtype.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

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
