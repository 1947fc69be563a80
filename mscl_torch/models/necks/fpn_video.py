"""TPNSingle: single-tower temporal pyramid (NCTHW).

Port of ``mscl_tpu/models/necks/fpn_video.py`` ``TPNSingle``: the last
len(in_channels) backbone stages -> FPN -> optional SEPC. The flagship sets
no ``temporal_modulation_cfg``; TemporalModulation is not ported yet.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..builder import NECKS
from .fpn import FPN
from .sepc import SEPC


@NECKS.register_module()
class TPNSingle(nn.Module):

    def __init__(self, in_channels: Sequence[int], out_channels: int,
                 fpn_cfg=None, temporal_modulation_cfg=None, sepc_cfg=None,
                 reverse_st: bool = False, dtype=None):
        super().__init__()
        if temporal_modulation_cfg is not None or reverse_st:
            raise NotImplementedError(
                'TPNSingle: temporal modulation is not ported yet')
        self.num_stages = len(in_channels)
        fpn_cfg = dict(fpn_cfg or dict(fpn_kerne_size=(1, 3, 3)))
        fpn_cfg.pop('conv_cfg', None)
        self.fpn = FPN(list(in_channels), out_channels, dtype=dtype,
                       **fpn_cfg)
        self.sepc = None
        if sepc_cfg is not None:
            sepc_cfg = dict(sepc_cfg)
            sepc_cfg['in_channels'] = list(sepc_cfg.get(
                'in_channels', [out_channels] * self.num_stages))
            self.sepc = SEPC(dtype=dtype, **sepc_cfg)

    def init_weights(self, gen: torch.Generator):
        self.fpn.init_weights(gen)
        if self.sepc is not None:
            self.sepc.init_weights(gen)

    def forward(self, x):
        outs = self.fpn(list(x[-self.num_stages:]))
        if self.sepc is not None:
            outs = self.sepc(outs)
        return outs
