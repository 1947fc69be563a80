"""TPNSingle: single-tower temporal pyramid (NCTHW).

Port of ``mscl_tpu/models/necks/fpn_video.py``: the last len(in_channels)
backbone stages -> FPN -> optional TemporalModulation per level -> optional
SEPC; with ``reverse_st`` the modulation runs on the backbone stages
before the FPN, at their own widths.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .. import compute_dtype
from ..builder import NECKS
from .fpn import FPN
from .sepc import SEPC


class TemporalModulation(nn.Module):
    """A grouped (32) 3x1x1 temporal conv without bias (xavier-uniform),
    from ``in_channels`` (default ``channels``) to ``channels``, then a
    temporal max-pool of kernel and stride ``downsample_scale`` in ceil
    mode: a last partial window takes the max of the frames it holds, as
    the JAX module's -inf padding gives."""

    def __init__(self, channels: int, downsample_scale: int = 8, dtype=None,
                 in_channels=None):
        super().__init__()
        self.dtype = compute_dtype.resolve_dtype(dtype)
        self.scale = downsample_scale
        self.conv = nn.Conv3d(in_channels or channels, channels, (3, 1, 1),
                              padding=(1, 0, 0), groups=32, bias=False)

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator):
        nn.init.xavier_uniform_(self.conv.weight, generator=gen)

    def forward(self, x):
        x = compute_dtype.conv3d(self.conv, x, self.dtype)
        s = self.scale
        return F.max_pool3d(x, (s, 1, 1), (s, 1, 1), ceil_mode=True)


@NECKS.register_module()
class TPNSingle(nn.Module):

    def __init__(self, in_channels: Sequence[int], out_channels: int,
                 fpn_cfg=None, temporal_modulation_cfg=None, sepc_cfg=None,
                 reverse_st: bool = False, dtype=None):
        super().__init__()
        self.num_stages = len(in_channels)
        self.reverse_st = reverse_st
        fpn_cfg = dict(fpn_cfg or dict(fpn_kerne_size=(1, 3, 3)))
        fpn_cfg.pop('conv_cfg', None)
        self.fpn = FPN(list(in_channels), out_channels, dtype=dtype,
                       **fpn_cfg)
        self.tm = None
        if temporal_modulation_cfg is not None:
            scales = temporal_modulation_cfg['downsample_scales']
            self.tm = [TemporalModulation(
                in_channels[i] if reverse_st else out_channels, scales[i],
                dtype) for i in range(self.num_stages)]
            for i, m in enumerate(self.tm):
                setattr(self, f'tm_{i}', m)
        self.sepc = None
        if sepc_cfg is not None:
            sepc_cfg = dict(sepc_cfg)
            sepc_cfg['in_channels'] = list(sepc_cfg.get(
                'in_channels', [out_channels] * self.num_stages))
            self.sepc = SEPC(dtype=dtype, **sepc_cfg)

    def init_weights(self, gen: torch.Generator):
        self.fpn.init_weights(gen)
        for m in self.tm or ():
            m.init_weights(gen)
        if self.sepc is not None:
            self.sepc.init_weights(gen)

    def _modulate(self, outs):
        if self.tm is None:
            return outs
        return [m(o) for m, o in zip(self.tm, outs)]

    def forward(self, x):
        outs = list(x[-self.num_stages:])
        if self.reverse_st:
            outs = self.fpn(self._modulate(outs))
        else:
            outs = self._modulate(self.fpn(outs))
        if self.sepc is not None:
            outs = self.sepc(outs)
        return outs
