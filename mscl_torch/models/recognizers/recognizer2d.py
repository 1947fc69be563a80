"""Recognizer2D: the frame-based classifier of TSN, TSM, TIN, TANet, TRN
and their kin.

Port of ``mscl_tpu/models/recognizers/recognizer2d.py`` (reference mmaction
recognizers/recognizer2d.py): a batch (B, segments, C, H, W) runs as
B * segments frames through the 2D backbone (NCHW, no transpose: the JAX
one moves C last), and the head forms the consensus over the segments.

- ``forward_train``: the head's loss; a reid head (``TSMReidSimpleHead``,
  ``FGTSMReidSimpleHead``) takes the labels in its forward (the cosface
  margin) and gives the pooled feature that its triplet loss reads. A
  multi-class target (N, classes) is refused by name: the JAX one
  flattens it and then fails in the loss (``tsn_r101_..._mmit``).
- ``forward_test``: the scores, softmaxed with ``average_clips='prob'``; a
  headless or ``feature_extraction`` model gives the pooled feature
  (``extract_features_pooled``: the last stage averaged over H and W, then
  over the segments).
- ``train_step``: the losses through ``parse_losses``.

A ``neck`` (TPN over 2D frames) is refused by name: ``necks/tpn.py`` is
not ported. The caller sets the mode (``model.eval()`` for testing).
Module names are the JAX tree's minus ``_m`` (``backbone``, ``cls_head``),
so ``convert.jax_to_state_dict`` covers the model.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .. import compute_dtype
from ..builder import BACKBONES, HEADS, RECOGNIZERS
from ..heads.reid_distill_heads import _ReidHeadBase
from .base import parse_losses
from .recognizer3d import Recognizer3D


@RECOGNIZERS.register_module()
class Recognizer2D(nn.Module):

    def __init__(self, backbone, cls_head=None, neck=None, train_cfg=None,
                 test_cfg=None, dtype=None):
        super().__init__()
        if neck is not None:
            raise NotImplementedError(
                f'Recognizer2D neck {dict(neck).get("type")!r} is not '
                f'ported (necks/tpn.py, ROADMAP.md Queue 1)')
        self.dtype = compute_dtype.resolve_dtype(dtype)
        bb_cfg = dict(backbone)
        bb_cfg.pop('pretrained', None)
        bb_type = bb_cfg.pop('type')
        factory = BACKBONES.get(bb_type)
        if factory is None:
            raise KeyError(
                f'unknown backbone {bb_type!r} (external torchvision/timm/'
                f'mmcls backbones are not in the registry)')
        self.backbone = factory(dtype=self.dtype, **bb_cfg)
        self.cls_head = None
        if cls_head is not None:
            head_cfg = dict(cls_head)
            head_type = head_cfg.pop('type')
            if HEADS.get(head_type) is None:
                raise KeyError(f'unknown head {head_type}')
            self.cls_head = HEADS.get(head_type)(dtype=self.dtype, **head_cfg)
        self.train_cfg = train_cfg
        self.test_cfg = dict(test_cfg or {})

    def init_weights(self, gen: torch.Generator):
        for m in (self.backbone, self.cls_head):
            if m is not None and hasattr(m, 'init_weights'):
                m.init_weights(gen)

    # the head's dropout generator, at the model's level (as Recognizer3D)
    seed_dropout = Recognizer3D.seed_dropout
    dropout_state = Recognizer3D.dropout_state
    set_dropout_state = Recognizer3D.set_dropout_state

    def _frames(self, imgs: torch.Tensor) -> Tuple[torch.Tensor, int]:
        """(B, segments, C, H, W) -> (B * segments, C, H, W) in the compute
        dtype, and the segment count."""
        return imgs.to(self.dtype).reshape((-1,) + tuple(imgs.shape[-3:])), \
            imgs.shape[1]

    def _feat(self, x):
        feat = self.backbone(x)
        return feat[-1] if isinstance(feat, (list, tuple)) else feat

    def forward_train(self, imgs: torch.Tensor, labels: torch.Tensor
                      ) -> Dict[str, torch.Tensor]:
        if self.cls_head is None:
            raise ValueError('Recognizer2D built without cls_head (a '
                             'feature-extraction config) cannot train')
        if labels.dim() > 1 and labels.shape[-1] > 1:
            # mscl_tpu flattens every target (recognizer2d.py:86), so a
            # (N, classes) one fails there in the loss's broadcast
            raise NotImplementedError(
                f'Recognizer2D with a multi_class target of shape '
                f'{tuple(labels.shape)}: the JAX Recognizer2D flattens the '
                f'labels and its loss then fails to broadcast them against '
                f'the scores; the port refuses it')
        x, num_segs = self._frames(imgs)
        feat = self._feat(x)
        labels = labels.reshape(-1)
        if isinstance(self.cls_head, _ReidHeadBase):
            cls_score, reid_feat = self.cls_head(
                feat, num_segs=num_segs, labels=labels, return_feat=True)
            return self.cls_head.loss(cls_score, labels, reid_feat=reid_feat)
        return self.cls_head.loss(self.cls_head(feat, num_segs=num_segs),
                                  labels)

    def forward_test(self, imgs: torch.Tensor) -> torch.Tensor:
        if self.cls_head is None or self.test_cfg.get('feature_extraction'):
            return self.extract_features_pooled(imgs)
        x, num_segs = self._frames(imgs)
        cls_score = self.cls_head(self._feat(x), num_segs=num_segs)
        if self.test_cfg.get('average_clips') == 'prob':
            cls_score = F.softmax(cls_score, dim=-1)
        return cls_score

    def extract_features_pooled(self, imgs: torch.Tensor) -> torch.Tensor:
        x, num_segs = self._frames(imgs)
        feat = self._feat(x).mean(dim=(2, 3))
        return feat.reshape(-1, num_segs, feat.shape[-1]).mean(dim=1)

    def forward(self, imgs, labels: Optional[torch.Tensor] = None,
                return_loss: bool = True):
        if return_loss and labels is not None:
            return self.forward_train(imgs, labels)
        return self.forward_test(imgs)

    def train_step(self, batch) -> Tuple[torch.Tensor, Dict]:
        return parse_losses(self.forward_train(batch['imgs'], batch['label']))
