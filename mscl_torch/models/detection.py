"""The AVA spatio-temporal action detector: ``merge_pathways``,
``SingleRoIExtractor3D``, ``BBoxHeadAVA``, ``AVAFastRCNN`` and its mmdet
name ``FastRCNN``.

Port of ``mscl_tpu/models/detection.py`` (reference
roi_extractors/single_straight3d.py, heads/bbox_head.py and the AVA
configs' FastRCNN). The backbone's map is NCTHW (a SlowFast backbone's, a
(slow, fast) pair); RoI features are channels-last (R, T', h, w, C), as
the JAX ones, which keeps RoIAlign's gathers contiguous in C and lets the
dropout masks of the two packages be laid alike.

- ``merge_pathways``: each pathway resized ('nearest', half-pixel
  centres: ``jax.image.resize``'s, torch's 'nearest-exact') to the
  longest T and the first pathway's H, W, temporally pooled (avg or max)
  with ``with_temporal_pool``, concatenated on C.
- ``SingleRoIExtractor3D``: ``ops.roi_align`` on each remaining frame
  (1 / ``featmap_stride`` scale); with ``with_global`` each RoI's clip's
  whole frame resized to ``output_size``^2 ('linear' with antialiasing
  when it shrinks: ``F.interpolate(..., antialias=True)``, which gives
  ``jax.image.resize``'s weights) and concatenated on C.
- ``BBoxHeadAVA``: dropout over the whole RoI tensor (before the pools
  with ``dropout_before_pool``), the temporal then the spatial pool, and
  ``fc_cls``; a (R, C) input (FBOHead's) skips the pools. ``loss``: a
  focal BCE (``focal_alpha``, ``focal_gamma``) over the classes but the
  first, meaned over the (RoI, class) entries of the RoIs with a positive
  label (and a positive weight); recall and precision at 0.5 and at the
  top k (no gradient; ``torch.topk`` and ``jax.lax.top_k`` order tied
  scores alike only where they tie at the k-th place, which random
  scores do not).
- ``AVAFastRCNN``: backbone -> RoI extractor -> shared head (``ACRNHead``
  on the merged map, ``FBOHead``; ``LFBInferHead`` passes the features
  through, as in JAX) -> ``BBoxHeadAVA``. ``train_step`` takes the
  pipeline's padded form (``rois`` (B, R, 4), ``roi_labels``,
  ``roi_weights``: flattened with batch indices, ``flatten_rois``) or the
  flat one (``rois`` (R, 5), ``labels``, ``valid_mask``). In training
  ``FBOHead``'s long-term feature is the RoI's own pooled one: the JAX
  step passes none (``mscl_tpu/models/detection.py:228-231``), so no bank
  is sampled in training. ``forward_test`` gives sigmoid scores and takes
  a sampled bank's ``lt_feat``.

The heads' input widths are the features' (the JAX Dense and Conv layers
size themselves from their input): the backbone's last stage (both
pathways' for SlowFast), twice that with ``with_global``; after
``FBOHead`` that plus its latent width ('non_local') or twice it; after
``ACRNHead`` its ``out_channels``. So ``lfb_nl``'s ``bbox_head.in_channels
=4096`` is read as JAX reads it: not at all (the feature is 2560 wide).

Dropout draws come from each site's own generator (``RateDropout``):
``BBoxHeadAVA``'s and FBO's three; the model's ``seed_dropout``,
``dropout_state`` and ``set_dropout_state`` cover them all in order.
Names are the JAX tree's minus ``_m`` (``backbone``, ``roi_extractor``,
``shared_head``, ``bbox_head.fc_cls``).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.roi_align import roi_align
from . import compute_dtype
from .backbones.resnet3d import ResNet3dSlowFast
from .builder import BACKBONES, HEADS, RECOGNIZERS
from .heads.base import RateDropout
from .heads.lfb import ACRNHead, FBOHead, _pool
from .recognizers.base import parse_losses
from .recognizers.recognizer3d import _registered


def _nearest(x: torch.Tensor, dim: int, size: int) -> torch.Tensor:
    """``x`` resized along ``dim`` to ``size`` by nearest neighbour with
    half-pixel centres (jax.image.resize's 'nearest')."""
    n = x.shape[dim]
    if n == size:
        return x
    idx = torch.floor((torch.arange(size, dtype=torch.float64) + 0.5) *
                      n / size).clamp(max=n - 1).to(torch.int64)
    return x.index_select(dim, idx.to(x.device))


def merge_pathways(feat, with_temporal_pool: bool = True,
                   temporal_pool_mode: str = 'avg') -> torch.Tensor:
    """NCTHW map(s) -> one NCTHW map (see the module's docstring)."""
    feats = list(feat) if isinstance(feat, (tuple, list)) else [feat]
    if len(feats) >= 2:
        max_t = max(f.shape[2] for f in feats)
        h, w = feats[0].shape[3], feats[0].shape[4]
        feats = [_nearest(_nearest(_nearest(f, 2, max_t), 3, h), 4, w)
                 for f in feats]
    if with_temporal_pool:
        feats = [f.mean(dim=2, keepdim=True) if temporal_pool_mode == 'avg'
                 else f.amax(dim=2, keepdim=True) for f in feats]
    return feats[0] if len(feats) == 1 else torch.cat(feats, dim=1)


@HEADS.register_module()
class SingleRoIExtractor3D(nn.Module):

    def __init__(self, roi_layer_type: str = 'RoIAlign',
                 featmap_stride: int = 16, output_size: int = 8,
                 sampling_ratio: int = 2, pool_mode: str = 'avg',
                 aligned: bool = True, with_temporal_pool: bool = True,
                 temporal_pool_mode: str = 'avg', with_global: bool = False):
        super().__init__()
        self.featmap_stride = featmap_stride
        self.output_size = output_size
        self.sampling_ratio = sampling_ratio
        self.aligned = aligned
        self.with_temporal_pool = with_temporal_pool
        self.temporal_pool_mode = temporal_pool_mode
        self.with_global = with_global

    def forward(self, feat, rois: torch.Tensor) -> torch.Tensor:
        """feat: NCTHW map(s); rois (R, 5) -> (R, T', out, out, C)."""
        feat = merge_pathways(feat, self.with_temporal_pool,
                              self.temporal_pool_mode)
        out = []
        for i in range(feat.shape[2]):
            frame = feat[:, :, i]                            # (B, C, H, W)
            rf = roi_align(frame.permute(0, 2, 3, 1), rois,
                           self.output_size, 1.0 / self.featmap_stride,
                           self.sampling_ratio, self.aligned)
            if self.with_global:
                size = (self.output_size, self.output_size)
                gf = F.interpolate(frame, size=size, mode='bilinear',
                                   align_corners=False, antialias=True)
                gf = gf.permute(0, 2, 3, 1)[rois[:, 0].to(torch.int64)]
                rf = torch.cat([rf, gf], dim=-1)
            out.append(rf)
        return torch.stack(out, dim=1)


@HEADS.register_module()
class BBoxHeadAVA(nn.Module):

    def __init__(self, temporal_pool_type: str = 'avg',
                 spatial_pool_type: str = 'max', in_channels: int = 2048,
                 focal_gamma: float = 0.0, focal_alpha: float = 1.0,
                 num_classes: int = 81, dropout_ratio: float = 0.0,
                 dropout_before_pool: bool = True,
                 topk: Sequence[int] = (3, 5), multilabel: bool = True,
                 dtype=None):
        super().__init__()
        self.dtype = compute_dtype.resolve_dtype(dtype)
        self.temporal_pool_type = temporal_pool_type
        self.spatial_pool_type = spatial_pool_type
        self.focal_gamma, self.focal_alpha = focal_gamma, focal_alpha
        self.dropout_before_pool = dropout_before_pool
        self.topk = tuple(topk)
        self.drop = RateDropout(dropout_ratio) if dropout_ratio > 0 \
            else None
        self.fc_cls = nn.Linear(in_channels, num_classes)

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator):
        nn.init.normal_(self.fc_cls.weight, 0.0, 0.01, generator=gen)
        self.fc_cls.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.drop is not None and self.dropout_before_pool:
            x = self.drop(x)
        if x.dim() == 5:
            x = _pool(x, self.temporal_pool_type, self.spatial_pool_type)
        if self.drop is not None and not self.dropout_before_pool:
            x = self.drop(x)
        return compute_dtype.linear(self.fc_cls, x, self.dtype)

    def loss(self, cls_score: torch.Tensor, labels: torch.Tensor,
             valid_mask: Optional[torch.Tensor] = None
             ) -> Dict[str, torch.Tensor]:
        score, target = cls_score[:, 1:], labels[:, 1:]
        pos = (target.sum(dim=-1) > 0).to(score.dtype)
        if valid_mask is not None:
            pos = pos * valid_mask
        n_valid = pos.sum().clamp_min(1.0)
        p = torch.sigmoid(score)
        bce = score.clamp_min(0) - score * target + \
            torch.log1p(torch.exp(-score.abs()))
        pt = torch.where(target > 0.5, p, 1 - p)
        focal = self.focal_alpha * (1 - pt) ** self.focal_gamma * bce
        losses = {'loss_action_cls': (focal * pos[:, None]).sum() /
                  (n_valid * score.shape[1])}
        with torch.no_grad():
            def row_mean(v):
                return (v * pos).sum() / n_valid

            pred_vec, target_vec = p > 0.5, target > 0.5
            tsum = target_vec.sum(dim=1).clamp_min(1)
            correct = (pred_vec & target_vec).sum(dim=1)
            losses['recall@thr=0.5'] = row_mean(correct / tsum)
            losses['prec@thr=0.5'] = row_mean(
                correct / pred_vec.sum(dim=1).clamp_min(1e-6))
            for k in self.topk:
                idx = torch.topk(p, k, dim=-1).indices
                onehot = torch.zeros_like(target_vec).scatter_(1, idx, True)
                ck = (onehot & target_vec).sum(dim=1)
                losses[f'recall@top{k}'] = row_mean(ck / tsum)
                losses[f'prec@top{k}'] = row_mean(ck / k)
        return losses


def _out_channels(backbone: nn.Module) -> int:
    """The width of a backbone's last stage (both pathways' for
    SlowFast)."""
    if isinstance(backbone, ResNet3dSlowFast):
        return _out_channels(backbone.slow_path) + \
            _out_channels(backbone.fast_path)
    last = backbone
    n = getattr(backbone, 'num_stages', None)
    if n is not None and hasattr(backbone, f'layer{n}'):
        last = getattr(backbone, f'layer{n}')[-1]
    bns = [m for m in last.modules() if hasattr(m, 'running_mean')]
    return bns[-1].weight.shape[0]


@RECOGNIZERS.register_module()
class AVAFastRCNN(nn.Module):

    def __init__(self, backbone, roi_head=None, train_cfg=None,
                 test_cfg=None, dtype=None):
        super().__init__()
        self.dtype = compute_dtype.resolve_dtype(dtype)
        bb_cfg = dict(backbone)
        bb_cfg.pop('pretrained', None)
        bb_cfg.pop('pretrained2d', None)
        self.backbone = _registered(BACKBONES, 'backbone',
                                    bb_cfg.pop('type'))(dtype=self.dtype,
                                                        **bb_cfg)
        rh = dict(roi_head or {})
        ext_cfg = dict(rh.get('bbox_roi_extractor') or {})
        ext_cfg.pop('type', None)
        self.roi_extractor = SingleRoIExtractor3D(**ext_cfg)
        feat_c = _out_channels(self.backbone)
        width = feat_c * (2 if self.roi_extractor.with_global else 1)
        sh_cfg = dict(rh.get('shared_head') or {})
        sh_type = sh_cfg.pop('type', None)
        self.shared_head_type = sh_type
        self.shared_head = None
        if sh_type == 'ACRNHead':
            sh_cfg['in_channels'] = width + feat_c
            self.shared_head = ACRNHead(dtype=self.dtype, **sh_cfg)
            width = sh_cfg.get('out_channels', 2048)
        elif sh_type == 'FBOHead':
            sh_cfg.pop('lfb_cfg', None)          # the bank is the host's
            self.shared_head = FBOHead(dtype=self.dtype, in_channels=width,
                                       **sh_cfg)
            width = self.shared_head.out_channels
        elif sh_type not in (None, 'LFBInferHead'):
            raise KeyError(f'unknown shared head {sh_type}')
        head_cfg = dict(rh.get('bbox_head') or {})
        head_cfg.pop('type', None)
        head_cfg['in_channels'] = width
        self.bbox_head = BBoxHeadAVA(dtype=self.dtype, **head_cfg)
        self.train_cfg = train_cfg
        self.test_cfg = dict(test_cfg or {})

    def init_weights(self, gen: torch.Generator):
        for m in (self.backbone, self.shared_head, self.bbox_head):
            if m is not None and hasattr(m, 'init_weights'):
                m.init_weights(gen)

    def _dropouts(self):
        return [m for m in self.modules() if isinstance(m, RateDropout)]

    def seed_dropout(self, seed: int):
        for i, m in enumerate(self._dropouts()):
            m.seed_dropout(seed + i)

    def dropout_state(self):
        states = [m.dropout_state() for m in self._dropouts()]
        if len(states) > 1:
            return states
        return states[0] if states else None

    def set_dropout_state(self, state) -> None:
        mods = self._dropouts()
        states = state if isinstance(state, list) else [state] * len(mods)
        for m, st in zip(mods, states):
            m.set_dropout_state(st)

    def extract_feat(self, imgs: torch.Tensor):
        imgs = imgs.reshape((-1,) + tuple(imgs.shape[-4:]))
        feats = self.backbone(imgs)
        return feats[-1] if isinstance(feats, list) else feats

    def _roi_feats(self, feat, rois, lt_feat=None):
        roi_feats = self.roi_extractor(feat, rois)
        if self.shared_head_type == 'ACRNHead':
            ctx = merge_pathways(feat, self.roi_extractor.with_temporal_pool,
                                 self.roi_extractor.temporal_pool_mode)
            roi_feats = self.shared_head(roi_feats, ctx, rois)
        elif self.shared_head_type == 'FBOHead':
            if lt_feat is None:     # no bank: the RoI's own pooled feature
                lt_feat = roi_feats.amax(dim=(2, 3)).mean(dim=1,
                                                          keepdim=True)
            roi_feats = self.shared_head(roi_feats, lt_feat)
        return roi_feats

    def forward_train(self, imgs, rois, labels, valid_mask=None,
                      lt_feat=None) -> Dict[str, torch.Tensor]:
        feat = self.extract_feat(imgs)
        cls_score = self.bbox_head(self._roi_feats(feat, rois, lt_feat))
        return self.bbox_head.loss(cls_score, labels, valid_mask)

    @staticmethod
    def flatten_rois(rois: torch.Tensor) -> torch.Tensor:
        """(B, R, 4) padded boxes -> (B * R, 5) with batch indices."""
        b, r, _ = rois.shape
        ids = torch.arange(b, dtype=rois.dtype,
                           device=rois.device).repeat_interleave(r)
        return torch.cat([ids[:, None], rois.reshape(b * r, 4)], dim=1)

    def forward_test(self, imgs, rois, lt_feat=None) -> torch.Tensor:
        feat = self.extract_feat(imgs)
        return torch.sigmoid(self.bbox_head(
            self._roi_feats(feat, rois, lt_feat)))

    def forward(self, imgs, rois, labels=None, return_loss: bool = True):
        if return_loss and labels is not None:
            return self.forward_train(imgs, rois, labels)
        return self.forward_test(imgs, rois)

    def train_step(self, batch) -> Tuple[torch.Tensor, Dict]:
        rois = batch.get('rois')
        if rois is None:
            raise KeyError('detection train_step needs "rois" in the batch')
        if rois.dim() == 3:
            b, r = rois.shape[:2]
            labels = batch['roi_labels'].reshape(b * r, -1)
            weights = batch['roi_weights'].reshape(b * r)
            losses = self.forward_train(batch['imgs'],
                                        self.flatten_rois(rois), labels,
                                        (weights > 0).to(labels.dtype))
        else:
            losses = self.forward_train(batch['imgs'], rois,
                                        batch['labels'],
                                        batch.get('valid_mask'))
        return parse_losses(losses)


@RECOGNIZERS.register_module()
class FastRCNN(AVAFastRCNN):
    """The mmdet name the reference's AVA configs give (``roi_head.type
    ='AVARoIHead'`` and the inner ``type`` keys are read as
    ``AVAFastRCNN`` reads them)."""
