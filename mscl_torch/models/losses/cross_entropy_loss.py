"""Cross-entropy with ignore_index.

Port of ``mscl_tpu/models/losses/cross_entropy_loss.py``
``CrossEntropyLoss_torch``: the mean over non-ignored samples, and 0 (not
NaN) when every sample is ignored, as the JAX function returns.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..builder import LOSSES


def cross_entropy(cls_score: torch.Tensor, label: torch.Tensor,
                  ignore_index: int = -100) -> torch.Tensor:
    label = label.long()
    valid = label != ignore_index
    nll = F.cross_entropy(cls_score, torch.where(valid, label, 0),
                          reduction='none')
    return (nll * valid).sum() / valid.sum().clamp(min=1)


@LOSSES.register_module()
class CrossEntropyLossTorch:

    def __init__(self, ignore_index=-100, loss_weight=1.0):
        self.ignore_index = ignore_index
        self.loss_weight = loss_weight

    def __call__(self, cls_score, label, **kwargs):
        return self.loss_weight * cross_entropy(cls_score, label,
                                                self.ignore_index)


LOSSES.register_module(name='CrossEntropyLoss_torch',
                       module=CrossEntropyLossTorch)
