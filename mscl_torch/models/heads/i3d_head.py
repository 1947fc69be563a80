"""I3DHead: the clip classifier of the fine-tune configs.

Port of ``mscl_tpu/models/heads/i3d_head.py`` (reference mmaction
heads/i3d_head.py): a 5-D NCTHW feature map is averaged over T, H and W
whatever ``spatial_type`` says ('none' names backbones that pool inside in
the reference; the port's do not), then dropout and ``fc_cls``,
initialised normal(0, ``init_std``) with a zero bias.

Dropout is ``base.SeededDropout``: the head's own generator, seeded
from ``dropout_seed``, its state saved in checkpoints.
"""
from __future__ import annotations

import torch
from torch import nn

from .. import compute_dtype
from ..builder import HEADS
from .base import BaseHead, SeededDropout


@HEADS.register_module()
class I3DHead(SeededDropout, BaseHead):

    def __init__(self, num_classes=400, in_channels=2048, loss_cls=None,
                 spatial_type='avg', dropout_ratio=0.5, init_std=0.01,
                 multi_class=False, label_smooth_eps=0.0, topk=(1, 5),
                 dtype=None):
        super().__init__(num_classes, loss_cls, multi_class,
                         label_smooth_eps, topk)
        self.dropout_ratio = dropout_ratio
        self.init_std = init_std
        self.dtype = compute_dtype.resolve_dtype(dtype)
        self.fc_cls = nn.Linear(in_channels, num_classes)

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator):
        nn.init.normal_(self.fc_cls.weight, 0.0, self.init_std, generator=gen)
        self.fc_cls.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() == 5:
            x = x.mean(dim=(2, 3, 4))
        return compute_dtype.linear(self.fc_cls, self.dropout(x), self.dtype)
