"""The recognition heads: TSN, TSM, TPN, AudioTSN, TimeSformer, X3D,
SlowFast and TRN.

Port of ``mscl_tpu/models/heads/recognition_heads.py``, in torch's layouts:
frames (N * segments, C, H, W), clips NCTHW, features (N, C); the
TimeSformer head takes (N, ..., C) tokens, channels last, as a transformer
gives them in either framework.

- ``TSNHead``, ``TSMHead``, ``TPNHead``, ``AudioTSNHead``: the spatial
  (and temporal) mean, dropout, ``fc_cls``, then the segment consensus, the
  mean of the scores over ``num_segs`` (``consensus=AvgConsensus`` names
  that and is not a module). TSMHead takes its ``num_segments`` when the
  recognizer gives none, halved with ``is_shift`` and ``temporal_pool``
  (the backbone pooled the segments).
- ``TimeSformerHead``: the token mean, dropout, ``fc_cls``; ``X3DHead``:
  ``fc1`` (no bias by default), ReLU, dropout, ``fc2``; ``SlowFastHead``:
  the two pathways' means concatenated, dropout, ``fc_cls``.
- ``TRNHead``: pooled (or flattened in JAX's (H, W, C) order), dropout,
  ``fc_cls`` to ``hidden_dim``, then the relation consensus: 'TRN' one MLP
  (``fusion_fc1`` to 512, ``fusion_fc2``) over all segments;
  'TRNMultiScale' the sum, over scales t, t-1, ..., 2, of an MLP
  (``scale{k}_fc1`` to 256, ``scale{k}_fc2``) over up to three ordered
  segment subsets a scale, summed. In training a scale with more than three
  subsets draws three distinct ones at random each forward: the JAX head
  draws them from its 'dropout' stream, the port from the head's own
  generator (``SeededDropout``), so the two draw different subsets
  (``relation_picks`` is the one place they are drawn); in eval the first
  three.

The classifiers are initialised normal(0, ``init_std``) with a zero bias
(TimeSformer's truncated at 2 std), the TRN MLPs as flax's Dense
(lecun-normal, zero bias). Dropout is ``base.SeededDropout``.
"""
from __future__ import annotations

import itertools
import torch
import torch.nn.functional as F
from torch import nn

from .. import compute_dtype
from ..builder import HEADS
from ..weight_init import lecun_normal_
from .base import BaseHead, SeededDropout


class _HeadBase(SeededDropout, BaseHead):

    def __init__(self, num_classes, loss_cls, multi_class, label_smooth_eps,
                 dropout_ratio, init_std, dtype, topk=(1, 5)):
        super().__init__(num_classes, loss_cls, multi_class,
                         label_smooth_eps, topk)
        self.dropout_ratio = dropout_ratio
        self.init_std = init_std
        self.dtype = compute_dtype.resolve_dtype(dtype)

    def _linear(self, layer, x):
        return compute_dtype.linear(layer, x, self.dtype)


class _PoolFCHead(_HeadBase):
    dropout_default = 0.4
    init_std_default = 0.01

    def __init__(self, num_classes=400, in_channels=2048, loss_cls=None,
                 dropout_ratio=None, init_std=None, spatial_type='avg',
                 multi_class=False, label_smooth_eps=0.0, consensus=None,
                 temporal_pool=False, topk=(1, 5), dtype=None):
        super().__init__(
            num_classes, loss_cls, multi_class, label_smooth_eps,
            self.dropout_default if dropout_ratio is None else dropout_ratio,
            self.init_std_default if init_std is None else init_std, dtype,
            topk)
        self.temporal_pool = temporal_pool
        self.fc_cls = nn.Linear(in_channels, num_classes)

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator):
        nn.init.normal_(self.fc_cls.weight, 0.0, self.init_std, generator=gen)
        self.fc_cls.bias.zero_()

    def forward(self, x, num_segs: int = 1):
        if x.dim() >= 4:                    # NCHW frames, NCTHW clips
            x = x.mean(dim=tuple(range(2, x.dim())))
        score = self._linear(self.fc_cls, self.dropout(x))
        if num_segs > 1:
            score = score.reshape((-1, num_segs) +
                                  score.shape[1:]).mean(dim=1)
        return score


@HEADS.register_module()
class TSNHead(_PoolFCHead):
    pass


@HEADS.register_module()
class TSMHead(_PoolFCHead):
    dropout_default = 0.8
    init_std_default = 0.001

    def __init__(self, *args, num_segments=8, is_shift=True, **kwargs):
        super().__init__(*args, **kwargs)
        self.num_segments, self.is_shift = num_segments, is_shift

    def forward(self, x, num_segs=None):
        num_segs = num_segs or self.num_segments
        if self.is_shift and self.temporal_pool:
            num_segs //= 2
        return super().forward(x, num_segs)


@HEADS.register_module()
class TPNHead(_PoolFCHead):
    dropout_default = 0.5


@HEADS.register_module()
class AudioTSNHead(_PoolFCHead):
    pass


@HEADS.register_module()
class TimeSformerHead(_HeadBase):

    def __init__(self, num_classes=400, in_channels=768, loss_cls=None,
                 init_std=0.02, dropout_ratio=0.0, multi_class=False,
                 label_smooth_eps=0.0, topk=(1, 5), dtype=None):
        super().__init__(num_classes, loss_cls, multi_class,
                         label_smooth_eps, dropout_ratio, init_std, dtype,
                         topk)
        self.fc_cls = nn.Linear(in_channels, num_classes)

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator):
        s = self.init_std / .87962566103423978
        nn.init.trunc_normal_(self.fc_cls.weight, 0.0, s, -2 * s, 2 * s,
                              generator=gen)
        self.fc_cls.bias.zero_()

    def forward(self, x, num_segs: int = 1):
        if x.dim() > 2:                     # (N, ..., C) tokens
            x = x.mean(dim=tuple(range(1, x.dim() - 1)))
        return self._linear(self.fc_cls, self.dropout(x))


@HEADS.register_module()
class X3DHead(_HeadBase):

    def __init__(self, num_classes=400, in_channels=432, mid_channels=2048,
                 spatial_type='avg', loss_cls=None, dropout_ratio=0.5,
                 init_std=0.01, fc1_bias=False, multi_class=False,
                 label_smooth_eps=0.0, topk=(1, 5), dtype=None):
        super().__init__(num_classes, loss_cls, multi_class,
                         label_smooth_eps, dropout_ratio, init_std, dtype,
                         topk)
        self.fc1 = nn.Linear(in_channels, mid_channels, bias=fc1_bias)
        self.fc2 = nn.Linear(mid_channels, num_classes)

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator):
        for fc in (self.fc1, self.fc2):
            nn.init.normal_(fc.weight, 0.0, self.init_std, generator=gen)
            if fc.bias is not None:
                fc.bias.zero_()

    def forward(self, x, num_segs: int = 1):
        if x.dim() == 5:
            x = x.mean(dim=(2, 3, 4))
        x = F.relu(self._linear(self.fc1, x))
        return self._linear(self.fc2, self.dropout(x))


@HEADS.register_module()
class SlowFastHead(_HeadBase):

    def __init__(self, num_classes=400, in_channels=2304, loss_cls=None,
                 spatial_type='avg', dropout_ratio=0.8, init_std=0.01,
                 multi_class=False, label_smooth_eps=0.0, topk=(1, 5),
                 dtype=None):
        super().__init__(num_classes, loss_cls, multi_class,
                         label_smooth_eps, dropout_ratio, init_std, dtype,
                         topk)
        self.fc_cls = nn.Linear(in_channels, num_classes)

    init_weights = _PoolFCHead.init_weights

    def forward(self, x, num_segs: int = 1):
        slow, fast = x
        pooled = torch.cat([slow.mean(dim=(2, 3, 4)),
                            fast.mean(dim=(2, 3, 4))], dim=-1)
        return self._linear(self.fc_cls, self.dropout(pooled))


@HEADS.register_module()
class TRNHead(_HeadBase):

    def __init__(self, num_classes=400, in_channels=2048, num_segments=8,
                 loss_cls=None, spatial_type='avg',
                 relation_type='TRNMultiScale', hidden_dim=256,
                 dropout_ratio=0.8, init_std=0.001, multi_class=False,
                 label_smooth_eps=0.0, topk=(1, 5), dtype=None):
        super().__init__(num_classes, loss_cls, multi_class,
                         label_smooth_eps, dropout_ratio, init_std, dtype,
                         topk)
        if relation_type not in ('TRN', 'TRNMultiScale'):
            raise ValueError(f'TRNHead relation_type {relation_type!r}')
        self.num_segments, self.hidden_dim = num_segments, hidden_dim
        self.spatial_type, self.relation_type = spatial_type, relation_type
        self.fc_cls = nn.Linear(in_channels, hidden_dim)
        t = num_segments
        if relation_type == 'TRN':
            self.fusion_fc1 = nn.Linear(t * hidden_dim, 512)
            self.fusion_fc2 = nn.Linear(512, num_classes)
        else:
            for k, scale in enumerate(range(t, 1, -1)):
                setattr(self, f'scale{k}_fc1',
                        nn.Linear(scale * hidden_dim, 256))
                setattr(self, f'scale{k}_fc2', nn.Linear(256, num_classes))

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator):
        nn.init.normal_(self.fc_cls.weight, 0.0, self.init_std, generator=gen)
        self.fc_cls.bias.zero_()
        for name, m in self.named_children():
            if isinstance(m, nn.Linear) and name != 'fc_cls':
                lecun_normal_(m.weight, gen)
                m.bias.zero_()

    def relation_picks(self, n_rel: int, n_sub: int, device) -> torch.Tensor:
        """Which ``n_sub`` of a scale's ``n_rel`` subsets this forward
        takes: distinct, drawn from the head's generator in training, the
        first ones otherwise."""
        if self.training and n_rel > n_sub:
            return torch.randperm(
                n_rel, generator=self.dropout_generator(device),
                device=device)[:n_sub]
        return torch.arange(n_sub, device=device)

    def _fusion(self, z, k):
        z = F.relu(z.reshape(z.shape[0], -1))
        z = F.relu(self._linear(getattr(self, f'scale{k}_fc1'), z))
        return self._linear(getattr(self, f'scale{k}_fc2'), z)

    def forward(self, x, num_segs=None):
        if x.dim() == 4:
            x = x.mean(dim=(2, 3)) if self.spatial_type == 'avg' else \
                x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        feat = self._linear(self.fc_cls, self.dropout(x))
        t = self.num_segments
        feat = feat.reshape(-1, t, self.hidden_dim)
        n = feat.shape[0]
        if self.relation_type == 'TRN':
            z = F.relu(feat.reshape(n, -1))
            z = F.relu(self._linear(self.fusion_fc1, z))
            return self._linear(self.fusion_fc2, z)
        score = self._fusion(feat, 0)
        for k, scale in enumerate(range(t - 1, 1, -1), start=1):
            rels = torch.tensor(list(itertools.combinations(range(t), scale)),
                                device=feat.device)
            n_sub = min(3, rels.shape[0])
            chosen = rels[self.relation_picks(rels.shape[0], n_sub,
                                              feat.device)]
            sub = feat[:, chosen.reshape(-1)].reshape(n * n_sub, scale,
                                                      self.hidden_dim)
            score = score + self._fusion(sub, k).reshape(
                n, n_sub, -1).sum(dim=1)
        return score
