"""Top-k accuracy, the classification heads' shared loss (port of
``mscl_tpu/models/heads/base.py``) and their seeded dropout.

``SeededDropout``: dropout draws its mask from the head's own
``torch.Generator``, made on the batch's device from ``dropout_seed`` at
first use, not from the global generator (in a process group: the global
batch's mask, seeded alike on every rank, and the rank's rows of it, so n
ranks drop what one device drops): its state is saved in checkpoints
(``dropout_state``) so a resumed run draws the masks the uninterrupted run
would. The mask keeps an element with probability 1 - p and scales it by
1 / (1 - p), as flax's Dropout does; its bits are not JAX's.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ...parallel import dist
from ..builder import build_loss


@torch.no_grad()
def topk_accuracy(cls_score: torch.Tensor, labels: torch.Tensor, k: int
                  ) -> torch.Tensor:
    """Sort-free top-k accuracy: the label's rank is the number of logits
    strictly greater than its own; ties count as hits, as in the JAX one."""
    labels = labels.reshape(-1).long()
    k = min(k, cls_score.shape[-1])
    label_logit = cls_score.gather(-1, labels[:, None])
    rank = (cls_score > label_logit).sum(dim=-1)
    return (rank < k).float().mean()


class BaseHead(nn.Module):
    """A classification head: subclasses give ``forward`` (the scores);
    ``loss`` gives ``top{k}_acc`` for each k of ``topk`` (hard labels
    only) and ``loss_cls`` (reference mmaction heads/base.py), with label
    smoothing of multi-class soft targets."""

    def __init__(self, num_classes, loss_cls=None, multi_class=False,
                 label_smooth_eps=0.0, topk=(1, 5)):
        super().__init__()
        self.num_classes = num_classes
        self.loss_cls = build_loss(dict(loss_cls or
                                        dict(type='CrossEntropyLoss')))
        self.multi_class = multi_class
        self.label_smooth_eps = label_smooth_eps
        self.topk = tuple(topk)

    def loss(self, cls_score: torch.Tensor, labels: torch.Tensor,
             **kwargs) -> Dict[str, torch.Tensor]:
        losses = {}
        if labels.dim() > 1 and labels.shape[-1] == 1:
            labels = labels.reshape(-1)
        if not self.multi_class and labels.dim() == 1:
            for k in self.topk:
                if k <= cls_score.shape[-1]:
                    losses[f'top{k}_acc'] = topk_accuracy(cls_score, labels,
                                                          k)
        if self.multi_class and self.label_smooth_eps != 0:
            labels = ((1 - self.label_smooth_eps) * labels +
                      self.label_smooth_eps / self.num_classes)
        losses['loss_cls'] = self.loss_cls(cls_score, labels, **kwargs)
        return losses


class SeededDropout:
    """Dropout at ``self.dropout_ratio`` from the head's own generator (see
    above); mixed into an ``nn.Module`` head."""
    dropout_seed = 0
    _dropout_gen: Optional[torch.Generator] = None

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
            device = next(self.parameters()).device
            self.dropout_generator(device).set_state(state)

    def dropout(self, x: torch.Tensor) -> torch.Tensor:
        p = self.dropout_ratio
        if not self.training or p == 0:
            return x
        shape = (x.shape[0] * dist.world_size(),) + tuple(x.shape[1:])
        u = dist.rank_rows(torch.rand(
            shape, generator=self.dropout_generator(x.device),
            device=x.device, dtype=torch.float32))
        return torch.where(u >= p, x / (1 - p), torch.zeros_like(x))


class RateDropout(SeededDropout, nn.Module):
    """``SeededDropout`` as a module of its own, with no parameters: the
    detection heads' dropout sites (``BBoxHeadAVA``'s, FBO's three), each
    with its own generator. A state put back before the first batch is
    applied when the generator is made on the batch's device."""

    def __init__(self, rate: float):
        nn.Module.__init__(self)
        self.dropout_ratio = rate
        self._pending = None

    def dropout_generator(self, device: torch.device) -> torch.Generator:
        gen = super().dropout_generator(device)
        if self._pending is not None:
            gen.set_state(self._pending)
            self._pending = None
        return gen

    def dropout_state(self) -> Optional[torch.Tensor]:
        return self._pending if self._dropout_gen is None else \
            self._dropout_gen.get_state()

    def set_dropout_state(self, state) -> None:
        self._dropout_gen, self._pending = None, state

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.dropout(x)
