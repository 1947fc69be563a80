"""MoCoHead: InfoNCE cross-entropy plus top-1/top-5 accuracy, logged under
'<name>_<basename>' (port of ``mscl_tpu/models/heads/moco_head.py``)."""
from __future__ import annotations

from typing import Dict

import torch

from ..builder import HEADS, build_loss
from .base import topk_accuracy


@HEADS.register_module()
class MoCoHead:

    def __init__(self, basename='', loss_cls=None, num_classes=2,
                 in_channels=128):
        self.basename = f'_{basename}' if basename else ''
        self.loss_cls = build_loss(dict(
            loss_cls or dict(type='CrossEntropyLoss_torch')))

    def loss(self, cls_score: torch.Tensor, labels: torch.Tensor,
             basename=None, **kwargs) -> Dict[str, torch.Tensor]:
        if basename is None:
            basename = self.basename
        losses = {}
        labels = torch.atleast_1d(labels)
        if cls_score.shape != labels.shape:
            losses[f'top1_acc{basename}'] = topk_accuracy(cls_score, labels, 1)
            losses[f'top5_acc{basename}'] = topk_accuracy(cls_score, labels, 5)
        losses[f'loss_cls{basename}'] = self.loss_cls(cls_score, labels)
        return losses
