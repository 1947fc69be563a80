"""Recognizer3D: the 3D-CNN clip classifier of fine-tuning, testing and
retrieval.

Port of ``mscl_tpu/models/recognizers/recognizer3d.py`` (reference mmaction
recognizers/recognizer3d.py), in NCTHW throughout:

- ``forward_train`` flattens the leading clip dimensions, runs the backbone
  (and the neck, if any), the head and its loss;
- ``forward_test`` takes (B, num_segs, C, T, H, W) (or (B, C, T, H, W)) and
  averages each video's clip scores: 'prob' is the mean of the softmaxes,
  'score' (or None) the mean of the scores;
- ``extract_features_pooled`` is the retrieval feature: each clip's last
  stage averaged over T, H and W, then the mean over segments.

Every path checks that a clip's channel axis (dim -4) is the backbone
stem's ``in_channels`` and raises a ``ValueError`` otherwise. A
``FormatShape('NTHWC')`` pipeline gives (..., T, H, W, C) clips: the JAX
``Recognizer3D`` reads those with T as the channel axis
(``mscl_tpu/models/recognizers/recognizer3d.py:25-32``), and its lazy stem
convolution takes T input channels without a word; the port refuses them.

The caller sets the mode: ``model.eval()`` before ``forward_test`` (BN's
running statistics, no dropout). Module names are the JAX tree's minus
``_m`` (``backbone``, ``neck``, ``cls_head.fc_cls``), so
``convert.jax_to_state_dict`` covers the model.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .. import compute_dtype
from ..builder import BACKBONES, HEADS, NECKS, RECOGNIZERS
from .base import parse_losses


def _registered(registry, kind: str, name: str):
    factory = registry.get(name)
    if factory is None:
        raise KeyError(f'unknown {kind} {name}')
    return factory


def _stem_channels(backbone: nn.Module) -> Optional[int]:
    """The input channels of the backbone's first convolution."""
    for m in backbone.modules():
        if isinstance(m, (nn.Conv3d, nn.Conv2d)):
            return m.in_channels
    return None


@RECOGNIZERS.register_module()
class Recognizer3D(nn.Module):

    def __init__(self, backbone, cls_head=None, neck=None, train_cfg=None,
                 test_cfg=None, dtype=None):
        super().__init__()
        self.dtype = compute_dtype.resolve_dtype(dtype)
        bb_cfg = dict(backbone)
        bb_cfg.pop('pretrained', None)
        factory = BACKBONES.get(bb_cfg.pop('type'))
        if factory is None:
            raise KeyError(f'unknown backbone {backbone["type"]}')
        self.backbone = factory(dtype=self.dtype, **bb_cfg)
        self.neck = None
        if neck is not None:
            neck_cfg = dict(neck)
            self.neck = _registered(NECKS, 'neck', neck_cfg.pop('type'))(
                dtype=self.dtype, **neck_cfg)
        self.cls_head = None
        if cls_head is not None:
            head_cfg = dict(cls_head)
            self.cls_head = _registered(HEADS, 'head', head_cfg.pop('type'))(
                dtype=self.dtype, **head_cfg)
        self.train_cfg = train_cfg
        self.test_cfg = dict(test_cfg or {})
        self.in_channels = _stem_channels(self.backbone)

    def _clips(self, imgs: torch.Tensor) -> torch.Tensor:
        """(..., C, T, H, W) -> (N, C, T, H, W), C checked."""
        if self.in_channels is not None and (
                imgs.dim() < 5 or imgs.shape[-4] != self.in_channels):
            raise ValueError(
                f'Recognizer3D takes clips as (..., C, T, H, W) with C = '
                f'{self.in_channels}, the backbone\'s in_channels; got '
                f'{tuple(imgs.shape)}. FormatShape(\'NTHWC\') gives '
                f'(..., T, H, W, C): format the clips as NCTHW. (mscl_tpu\'s '
                f'Recognizer3D reads an NTHWC batch with T as the channel '
                f'axis and sizes its stem to T without a word.)')
        return imgs.reshape((-1,) + tuple(imgs.shape[-4:]))

    def init_weights(self, gen: torch.Generator):
        for m in (self.backbone, self.neck, self.cls_head):
            if m is not None and hasattr(m, 'init_weights'):
                m.init_weights(gen)

    # the head's dropout generator, at the model's level for the
    # checkpoint and the Runner
    def seed_dropout(self, seed: int):
        if hasattr(self.cls_head, 'seed_dropout'):
            self.cls_head.seed_dropout(seed)

    def dropout_state(self):
        return self.cls_head.dropout_state() \
            if hasattr(self.cls_head, 'dropout_state') else None

    def set_dropout_state(self, state) -> None:
        if hasattr(self.cls_head, 'set_dropout_state'):
            self.cls_head.set_dropout_state(state)

    def extract_feat(self, imgs: torch.Tensor):
        """The backbone's last stage (a list is its stages)."""
        feats = self.backbone(imgs)
        return feats[-1] if isinstance(feats, list) else feats

    def _neck_feat(self, feats, labels=None
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The neck on the backbone's stages: its fused feature (the last
        of a list) and its auxiliary losses."""
        if not isinstance(feats, (list, tuple)):
            feats = [feats]
        out, aux_losses = self.neck(list(feats), labels=labels)
        if isinstance(out, (list, tuple)):
            out = out[-1]
        return out, aux_losses

    def forward_train(self, imgs: torch.Tensor, labels: torch.Tensor
                      ) -> Dict[str, torch.Tensor]:
        imgs = self._clips(imgs)
        labels = labels.reshape(-1)
        if self.neck is not None:
            x, aux_losses = self._neck_feat(self.backbone(imgs), labels)
            losses = dict(self.cls_head.loss(self.cls_head(x), labels))
            losses.update(aux_losses)
            return losses
        return self.cls_head.loss(self.cls_head(self.extract_feat(imgs)),
                                  labels)

    def forward_test(self, imgs: torch.Tensor) -> torch.Tensor:
        """(B, num_segs, C, T, H, W) -> (B, num_classes), averaged over the
        segments; a headless or feature_extraction model gives the pooled
        feature."""
        if self.cls_head is None or self.test_cfg.get('feature_extraction'):
            return self.extract_features_pooled(imgs)
        batches = imgs.shape[0]
        num_segs = imgs.shape[1] if imgs.dim() == 6 else 1
        if self.neck is not None:
            x, _ = self._neck_feat(self.backbone(self._clips(imgs)))
        else:
            x = self.extract_feat(self._clips(imgs))
        cls_score = self.cls_head(x).reshape(batches, num_segs, -1)
        if self.test_cfg.get('average_clips') == 'prob':
            return F.softmax(cls_score, dim=-1).mean(dim=1)
        return cls_score.mean(dim=1)

    def extract_features_pooled(self, imgs: torch.Tensor) -> torch.Tensor:
        """Each clip's last stage averaged over T, H, W; the mean over
        segments (reference recognizer3d.py:67-93)."""
        batches = imgs.shape[0]
        num_segs = imgs.shape[1] if imgs.dim() == 6 else 1
        feat = self.extract_feat(self._clips(imgs))
        if feat.dim() == 5:
            feat = feat.mean(dim=(2, 3, 4))
        return feat.reshape(batches, num_segs, -1).mean(dim=1)

    def forward(self, imgs, labels: Optional[torch.Tensor] = None,
                return_loss: bool = True):
        if return_loss and labels is not None:
            return self.forward_train(imgs, labels)
        return self.forward_test(imgs)

    def train_step(self, batch) -> Tuple[torch.Tensor, Dict]:
        return parse_losses(self.forward_train(batch['imgs'], batch['label']))
