"""Feature-level MoCo heads and the Mean-Shift (MSF) ablation heads.

Port of ``mscl_tpu/models/heads/moco_head_v3.py`` (reference
mmaction/models/heads/moco_head_v3.py:16-389):

- ``MoCoHeadV2``: InfoNCE from (q, k) and a queue;
- ``MSFHead``: mean shift, the mean distance of q to its key's top-k
  nearest queue entries, with the label purity of those entries;
- ``NMSFHead``: MSF with negatives, through a multi-positive loss
  (``losses/circle_loss.py``);
- ``MSCLWithAugMSFMxHead``: the cross-modal MSF of MSCLWithAug, MSCL and
  MoDist (their ``moco_mx_head``);
- ``MSCLWithAugDistillMxHead``: the cross-modal InfoNCE plus a KL
  distillation of the queue similarities (``small_p``: over the flow's
  ``small_p`` nearest entries only).

As the port's other heads, these take a queue as a bank ``(queue, decay)``
(``recognizers/moco.py``), not the dense decayed (C, K) matrix: every
(B, C) x (C, K) product against a queue runs in the decayed-InfoNCE kernels
on the card. A product whose query needs a gradient goes through
``decayed_neg`` (the forward kernel and the dq kernel); one on the
stop-gradient key, which only picks the top-k entries, through the forward
kernel alone. The distances are float32, as the JAX einsums against the
float32 queue make them. ``torch.topk`` and ``jax.lax.top_k`` may order
ties otherwise; every loss here is order-free over the top-k set, so only a
tie at the k-th place could pick another member.

JAX's MSCL recognizers cannot run ``MSCLWithAugDistillMxHead``: its
``forward_moco_mx`` returns four values where they unpack three, and its
``loss`` needs ``loss_kl``, which they do not pass. The port's recognizers
refuse it by name (``recognizers/mscl.py``); it is held as a head alone.
Nor does any JAX recognizer give ``MSFHead`` or ``NMSFHead`` the ``label``
and ``label_queue`` they take, so they too are heads alone.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..builder import HEADS, build_loss
from ...ops.decayed_infonce import decayed_neg, l_neg
from .base import topk_accuracy


def _key_sim(k: torch.Tensor, bank) -> torch.Tensor:
    """k @ (queue * decay) in float32 with no gradient: the forward kernel
    alone on the card."""
    return l_neg(k.detach().float().contiguous(), *bank)


def _query_sim(q: torch.Tensor, bank) -> torch.Tensor:
    """q @ (queue * decay) in float32, differentiable in q."""
    return decayed_neg(q.float(), *bank)


def _labels_at(label_queue, label, nn_index):
    """1 where a picked queue entry's label is the sample's, else 0."""
    return (label_queue[nn_index] == label[:, None]).float()


@HEADS.register_module()
class MoCoHeadV2:

    def __init__(self, basename='', loss_cls=None, num_classes=2,
                 in_channels=128, T=0.07):
        self.basename = f'_{basename}' if basename else ''
        self.T = T
        self.loss_cls = build_loss(dict(
            loss_cls or dict(type='CrossEntropyLoss')))

    def __call__(self, q, k, bank, **kwargs) -> Dict[str, torch.Tensor]:
        l_pos = (q * k).sum(dim=1, keepdim=True)
        logits = torch.cat([l_pos.float(), _query_sim(q, bank)],
                           dim=1) / self.T
        ssl_label = torch.zeros(logits.shape[0], dtype=torch.long,
                                device=logits.device)
        return dict(cls_score=logits, ssl_label=ssl_label)

    forward = __call__

    def loss(self, cls_score, ssl_label, basename=None, **kwargs) -> Dict:
        b = self.basename if basename is None else basename
        return {f'top1_acc{b}': topk_accuracy(cls_score, ssl_label, 1),
                f'top5_acc{b}': topk_accuracy(cls_score, ssl_label, 5),
                f'loss_cls{b}': self.loss_cls(cls_score, ssl_label)}

    def loss_mx(self, **kwargs):
        return dict()


@HEADS.register_module()
class MSFHead:
    """Pull q towards the top-k queue entries nearest its key."""

    def __init__(self, basename='', loss_cls=None, num_classes=2,
                 in_channels=128, topk=5):
        self.basename = f'_{basename}' if basename else ''
        self.topk = topk

    def __call__(self, q, k, bank, label, label_queue, **kwargs
                 ) -> Dict[str, torch.Tensor]:
        dist_t = 2 - 2 * _key_sim(k, bank)
        dist_q = 2 - 2 * _query_sim(q, bank)
        nn_index = torch.topk(-dist_t, self.topk, dim=1).indices
        return dict(nn_dist_q=dist_q.gather(1, nn_index),
                    matches=_labels_at(label_queue, label, nn_index))

    forward = __call__

    def loss(self, nn_dist_q, matches, basename=None, **kwargs) -> Dict:
        b = self.basename if basename is None else basename
        return {f'loss_msf{b}': (nn_dist_q.sum(dim=1) / self.topk).mean(),
                f'msf_purity{b}':
                    (matches.sum(dim=1) / self.topk).mean().detach()}

    def loss_mx(self, **kwargs):
        return dict()


def _msf_sp_sn(q, k, bank, topk, T
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The key's top-k queue entries are q's positives, every other entry
    a negative: sp (B, topk), sn (B, K) with -1e6 at the positives, both
    scaled by 1/T; and the top-k indices."""
    dist_t = _key_sim(k, bank)
    dist_q = _query_sim(q, bank) / T
    nn_index = torch.topk(dist_t, topk, dim=1).indices
    sp = dist_q.gather(1, nn_index)
    mask = torch.zeros_like(dist_q).scatter_(1, nn_index, 1.0)
    sn = dist_q * (1 - mask) + (-1e6) * mask
    return sp, sn, nn_index


@HEADS.register_module()
class NMSFHead:
    """MSF with the rest of the queue as negatives."""

    def __init__(self, basename='', loss_cls=None, num_classes=2,
                 in_channels=128, T=0.07, topk=5, pos_type='sum'):
        self.basename = f'_{basename}' if basename else ''
        self.T = T
        self.topk = topk
        self.loss_cls = build_loss(dict(
            loss_cls or dict(type='MultiPositiveSumLoss')))

    def __call__(self, q, k, bank, label, label_queue, **kwargs
                 ) -> Dict[str, torch.Tensor]:
        # JAX takes the key's top-k a second time, from the same product
        sp, sn, nn_index = _msf_sp_sn(q, k, bank, self.topk, self.T)
        return dict(sp=sp, sn=sn,
                    matches=_labels_at(label_queue, label, nn_index))

    forward = __call__

    def loss(self, sp, sn, matches, basename=None, **kwargs) -> Dict:
        b = self.basename if basename is None else basename
        return {f'loss_circle{b}': self.loss_cls(sp, sn),
                f'msf_purity{b}':
                    (matches.sum(dim=1) / self.topk).mean().detach()}

    def loss_mx(self, **kwargs):
        return dict()


@HEADS.register_module()
class MSCLWithAugMSFMxHead:
    """Cross-modal MSF: RGB's query against the flow key's top-k entries
    and the flow's query against the RGB key's; with same_kn each against
    the key's own modality's queue."""

    def __init__(self, basename='', loss_cls=None, num_classes=2,
                 in_channels=128, same_kn=True, T=0.07, topk=5,
                 pos_type='sum'):
        self.basename = f'_{basename}' if basename else ''
        self.same_kn = same_kn
        self.T = T
        self.topk = topk
        self.loss_cls = build_loss(dict(
            loss_cls or dict(type='MultiPositiveSumLoss')))

    def forward_moco_mx(self, q, k, q_flow, k_flow, bank, bank_flow):
        rf_bank, fr_bank = (bank_flow, bank) if self.same_kn else \
            (bank, bank_flow)
        rf = _msf_sp_sn(q, k_flow, rf_bank, self.topk, self.T)[:2]
        fr = _msf_sp_sn(q_flow, k, fr_bank, self.topk, self.T)[:2]
        ssl_label = torch.zeros(rf[0].shape[0], dtype=torch.long,
                                device=rf[0].device)
        return rf, fr, ssl_label

    def _loss_mx(self, logits, basename) -> Dict:
        return {f'loss_circle{basename}': self.loss_cls(*logits)}

    def loss(self, rf_logits, fr_logits, ssl_label, suffix='') -> Dict:
        losses = self._loss_mx(rf_logits, self.basename + suffix)
        losses.update(self._loss_mx(fr_logits,
                                    self.basename + '_r' + suffix))
        return losses


@HEADS.register_module()
class MSCLWithAugDistillMxHead:
    """The cross-modal InfoNCE of MSCLWithAugMxHead, plus KL(p_flow ||
    p_rgb) of the softmaxed similarities of each modality's query to its
    own queue (over the ``small_p`` entries nearest the flow query, if
    set), summed and divided by the batch (KLDivLoss 'batchmean')."""

    def __init__(self, basename='', loss_cls=None, num_classes=2,
                 in_channels=128, same_kn=True, T=0.07,
                 small_p: Optional[int] = None):
        self.basename = f'_{basename}' if basename else ''
        self.same_kn = same_kn
        self.T = T
        self.small_p = small_p
        self.loss_cls = build_loss(dict(
            loss_cls or dict(type='CrossEntropyLoss')))

    def forward_moco_mx(self, q, k, q_flow, k_flow, bank, bank_flow):
        rf_l_pos = (q * k_flow).sum(dim=1, keepdim=True)
        fr_l_pos = (q_flow * k).sum(dim=1, keepdim=True)
        rf_bank, fr_bank = (bank_flow, bank) if self.same_kn else \
            (bank, bank_flow)
        rf_logits = torch.cat([rf_l_pos.float(), _query_sim(q, rf_bank)],
                              dim=1) / self.T
        fr_logits = torch.cat([fr_l_pos.float(),
                               _query_sim(q_flow, fr_bank)], dim=1) / self.T
        p_rgb = _query_sim(q, bank)
        p_flow = _query_sim(q_flow, bank_flow)
        if self.small_p is not None:
            dist_t = 2 - 2 * p_flow
            nn_index = torch.topk(-dist_t, self.small_p, dim=1).indices
            p_rgb = p_rgb.gather(1, nn_index)
            p_flow = p_flow.gather(1, nn_index)
        p_rgb = torch.softmax(p_rgb, dim=-1)
        p_flow = torch.softmax(p_flow, dim=-1)
        loss_kl = (p_flow * (p_flow.clamp(min=1e-12).log() -
                             p_rgb.clamp(min=1e-12).log())).sum() / \
            p_rgb.shape[0]
        ssl_label = torch.zeros(rf_logits.shape[0], dtype=torch.long,
                                device=rf_logits.device)
        return rf_logits, fr_logits, ssl_label, dict(loss_kl=loss_kl)

    def _loss_mx(self, cls_score, labels, basename) -> Dict:
        return {f'top1_acc{basename}': topk_accuracy(cls_score, labels, 1),
                f'top5_acc{basename}': topk_accuracy(cls_score, labels, 5),
                f'loss_cls{basename}': self.loss_cls(cls_score, labels)}

    def loss(self, rf_logits, fr_logits, ssl_label, loss_kl, suffix='',
             **kwargs) -> Dict:
        losses = self._loss_mx(rf_logits, ssl_label, self.basename + suffix)
        losses.update(self._loss_mx(fr_logits, ssl_label,
                                    self.basename + '_r' + suffix))
        losses['loss_kl'] = loss_kl
        return losses
