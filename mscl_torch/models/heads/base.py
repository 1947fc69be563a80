"""Top-k accuracy and the classification heads' shared loss (port of
``mscl_tpu/models/heads/base.py``)."""
from __future__ import annotations

from typing import Dict

import torch
from torch import nn

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
