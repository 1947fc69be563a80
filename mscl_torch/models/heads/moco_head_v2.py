"""MSCLWithAugMxHead: cross-modal RGB<->flow InfoNCE.

Port of ``mscl_tpu/models/heads/moco_head_v2.py``. With same_kn each
direction takes the *other* modality's decayed queue as negatives. A queue
arrives as a bank ``(queue, decay)`` taken before its tower enqueued, and
each negative product runs in the decayed-InfoNCE kernel, so the decayed
(C, K) matrix is never materialised. As in the JAX einsums, l_pos stays in
the features' dtype and l_neg (with the float32 queue) is float32.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..builder import HEADS, build_loss
from ...ops.decayed_infonce import decayed_neg
from .base import topk_accuracy


@HEADS.register_module()
class MSCLWithAugMxHead:

    def __init__(self, basename='', loss_cls=None, num_classes=2,
                 in_channels=128, same_kn=True, T=0.07):
        self.basename = f'_{basename}' if basename else ''
        self.same_kn = same_kn
        self.T = T
        self.loss_cls = build_loss(dict(
            loss_cls or dict(type='CrossEntropyLoss_torch')))

    def forward_moco_mx(self, q, k, q_flow, k_flow, bank, bank_flow
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        rf_l_pos = (q * k_flow).sum(dim=1, keepdim=True)
        fr_l_pos = (q_flow * k).sum(dim=1, keepdim=True)
        rf_bank, fr_bank = (bank_flow, bank) if self.same_kn else \
            (bank, bank_flow)
        rf_l_neg = decayed_neg(q.float(), *rf_bank)
        fr_l_neg = decayed_neg(q_flow.float(), *fr_bank)
        rf_logits = torch.cat([rf_l_pos.float(), rf_l_neg], dim=1) / self.T
        fr_logits = torch.cat([fr_l_pos.float(), fr_l_neg], dim=1) / self.T
        ssl_label = torch.zeros(rf_logits.shape[0], dtype=torch.long,
                                device=rf_logits.device)
        return rf_logits, fr_logits, ssl_label

    def _loss_mx(self, cls_score, labels, basename) -> Dict:
        return {f'top1_acc{basename}': topk_accuracy(cls_score, labels, 1),
                f'top5_acc{basename}': topk_accuracy(cls_score, labels, 5),
                f'loss_cls{basename}': self.loss_cls(cls_score, labels)}

    def loss(self, rf_logits, fr_logits, ssl_label, suffix='') -> Dict:
        losses = self._loss_mx(rf_logits, ssl_label, self.basename + suffix)
        losses.update(self._loss_mx(fr_logits, ssl_label,
                                    self.basename + '_r' + suffix))
        return losses
