"""I3DHead: the clip classifier of the fine-tune configs.

Port of ``mscl_tpu/models/heads/i3d_head.py`` (reference mmaction
heads/i3d_head.py): a 5-D NCTHW feature map is averaged over T, H and W
whatever ``spatial_type`` says ('none' names backbones that pool inside in
the reference; the port's do not), then dropout and ``fc_cls``,
initialised normal(0, ``init_std``) with a zero bias.

Dropout draws its mask from the head's own ``torch.Generator``, made on the
batch's device from ``dropout_seed`` at first use, not from the global
generator (in a process group: the global batch's mask, seeded alike on
every rank, and the rank's rows of it, so n ranks drop what one device
drops): its state is saved in checkpoints (``dropout_state``) so a
resumed run draws the masks the uninterrupted run would. The mask keeps an
element with probability 1 - p and scales it by 1 / (1 - p), as flax's
Dropout does; its bits are not JAX's.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ...parallel import dist
from .. import compute_dtype
from ..builder import HEADS
from .base import BaseHead


@HEADS.register_module()
class I3DHead(BaseHead):

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
        self.dropout_seed, self._dropout_gen = 0, None

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator):
        nn.init.normal_(self.fc_cls.weight, 0.0, self.init_std, generator=gen)
        self.fc_cls.bias.zero_()

    def seed_dropout(self, seed: int):
        """Restart the dropout draws from seed (on the next batch's
        device)."""
        self.dropout_seed, self._dropout_gen = seed, None

    def dropout_generator(self, device: torch.device) -> torch.Generator:
        if self._dropout_gen is None or self._dropout_gen.device != device:
            self._dropout_gen = torch.Generator(device=device).manual_seed(
                self.dropout_seed)
        return self._dropout_gen

    def dropout_state(self) -> Optional[torch.Tensor]:
        """The dropout generator's state (a CPU byte tensor), None before
        the first training batch made it."""
        return None if self._dropout_gen is None else \
            self._dropout_gen.get_state()

    def set_dropout_state(self, state) -> None:
        """Put the generator back as ``dropout_state`` gave it, on the
        head's device (None: made from dropout_seed at the next batch)."""
        self._dropout_gen = None
        if state is not None:
            self.dropout_generator(self.fc_cls.weight.device).set_state(state)

    def dropout(self, x: torch.Tensor) -> torch.Tensor:
        p = self.dropout_ratio
        if not self.training or p == 0:
            return x
        shape = (x.shape[0] * dist.world_size(),) + tuple(x.shape[1:])
        u = dist.rank_rows(torch.rand(
            shape, generator=self.dropout_generator(x.device),
            device=x.device, dtype=torch.float32))
        return torch.where(u >= p, x / (1 - p), torch.zeros_like(x))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() == 5:
            x = x.mean(dim=(2, 3, 4))
        return compute_dtype.linear(self.fc_cls, self.dropout(x), self.dtype)
