"""The frame-alignment heads of the MSCL ablations (the MoDist*/MSCL*
pos-head family).

Port of ``mscl_tpu/models/heads/local_align_heads.py``. Each head pools
the RGB and flow features (NCTHW) to (b, t, c), optionally projects them,
L2-normalises them and scores every RGB frame against every flow frame
(cosine / T), with the labels arange(t) tiled over the batch: the
cross-entropy asks each frame to find its own flow frame. The fine-grained
heads do the same per spatial position. Internally the features are taken
channels-last, as the JAX heads hold them, so the flattening order of the
scores is theirs.

The projections are flax ``nn.Dense`` layers: their input width comes from
the first input (``Dense``), not from ``bkb_channels``, which only says
whether a projection exists. Their weights are lecun-normal with a zero
bias, drawn from a seed that ``init_weights`` takes from its generator.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .. import compute_dtype
from ..builder import HEADS, build_loss
from .base import topk_accuracy
from ..weight_init import lecun_normal_


class Dense(nn.LazyLinear):
    """flax ``nn.Dense(features, dtype)``: the input width is the first
    input's last axis; the weights are lecun-normal (a normal truncated at
    two standard deviations, of variance 1 / fan_in) and the bias zero,
    drawn when the layer takes its shape, from the seed ``init_weights``
    drew. A state dict loaded before the first call gives the shape too."""
    cls_to_become = None
    seed = None

    def __init__(self, features: int, dtype: torch.dtype):
        super().__init__(features)
        self.dtype = dtype

    def init_weights(self, gen: torch.Generator):
        self.seed = int(torch.randint(0, 2 ** 62, (), generator=gen))
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self):
        if self.seed is None or self.has_uninitialized_params():
            return
        self.in_features = self.weight.shape[1]
        lecun_normal_(self.weight, torch.Generator().manual_seed(self.seed))
        self.bias.zero_()

    def forward(self, x):
        return compute_dtype.linear(self, x, self.dtype)


def _l2norm(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=dim, keepdim=True).clamp_min(
        1e-12)


def _channels_last(x: torch.Tensor) -> torch.Tensor:
    """NCTHW -> (b, t, h, w, c)."""
    return x.permute(0, 2, 3, 4, 1)


def _frames(x: torch.Tensor) -> torch.Tensor:
    """NCTHW -> (b, t, c), spatially averaged."""
    return x.mean(dim=(3, 4)).transpose(1, 2)


def frame_sim_scores(x_q: torch.Tensor, x_q_flow: torch.Tensor, T: float
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(b, t, c) x (b, s, c) -> flattened (b*t, s) similarity logits and
    arange(t) labels."""
    sim = torch.einsum('btc,bsc->bts', _l2norm(x_q), _l2norm(x_q_flow))
    b, t = sim.shape[:2]
    return (sim.reshape(b * t, -1) / T,
            torch.arange(t, device=sim.device).repeat(b))


def _fine_grained_sim(x_q: torch.Tensor, x_f: torch.Tensor) -> torch.Tensor:
    """(b, t, H, W, c) RGB, 4x4 average-pooled, against (b, t, H/4, W/4, c)
    flow, per position: (b, H/4, W/4, t, s), both L2-normalised."""
    b, t, h, w, c = x_q.shape
    x_q = x_q.reshape(b, t, h // 4, 4, w // 4, 4, c).mean(dim=(3, 5))
    x_q = torch.movedim(_l2norm(x_q), 1, 3)
    x_f = torch.movedim(_l2norm(x_f), 1, 3)
    return torch.einsum('bhwtc,bhwsc->bhwts', x_q, x_f)


class _AlignBase(nn.Module):
    """The family's configuration, projections and losses."""
    rgb_trans_style = 'conv1'
    flow_trans_style = 'conv1'

    def __init__(self, basename='', loss_cls=None, loss_pos=None,
                 num_classes=2, in_channels=128,
                 mlvl_ids: Sequence[int] = (0, -1),
                 bkb_channels: Tuple = (512, 128), t=8, T=0.07,
                 aux_keys=None, dtype=None):
        super().__init__()
        self.dtype = compute_dtype.resolve_dtype(dtype)
        self.mlvl_ids = tuple(mlvl_ids)
        self.bkb_channels = tuple(bkb_channels)
        self.T = T
        self.aux_keys = aux_keys or {}
        self.loss_pos = build_loss(dict(loss_pos or
                                        dict(type='CrossEntropyLoss')))
        self.loss_cls = build_loss(dict(loss_cls or
                                        dict(type='CrossEntropyLoss')))

    def _make_trans(self, rgb_style=None, flow_style=None):
        """The projections the styles and ``bkb_channels`` call for (flax
        names: trans_rgb or trans_rgb_0/_1, trans_flow)."""
        if rgb_style is not None and self.bkb_channels[0] is not None:
            if rgb_style == 'mlp2':
                self.trans_rgb_0 = Dense(128, self.dtype)
                self.trans_rgb_1 = Dense(128, self.dtype)
            else:
                self.trans_rgb = Dense(128, self.dtype)
        if flow_style not in (None, 'identity', 'detach') and \
                self.bkb_channels[1] is not None:
            self.trans_flow = Dense(128, self.dtype)

    def _trans_rgb(self, x, style):
        if self.bkb_channels[0] is None:
            return x
        if style == 'mlp2':
            return self.trans_rgb_1(F.relu(self.trans_rgb_0(x)))
        return self.trans_rgb(x)

    def _trans_flow(self, x, style='conv1'):
        if style == 'identity' or self.bkb_channels[1] is None:
            return x
        if style == 'detach':
            return x.detach()
        return self.trans_flow(x)

    def init_weights(self, gen: torch.Generator):
        for m in self.modules():
            if isinstance(m, Dense):
                m.init_weights(gen)

    def _pos_losses(self, pos_scores, pos_labels) -> Dict:
        # an ignored label (-1) reads the last column, as JAX's
        # take_along_axis wraps a negative index
        wrapped = pos_labels.reshape(-1) % pos_scores.shape[-1]
        return {'loss_pos': self.loss_pos(pos_scores, pos_labels),
                'top1_acc_pos': topk_accuracy(pos_scores, wrapped, 1),
                'top5_acc_pos': topk_accuracy(pos_scores, wrapped, 5)}

    def loss(self, pos_scores, pos_labels, **kwargs) -> Dict:
        return self._pos_losses(pos_scores, pos_labels)

    def loss_mx(self, pos_scores, pos_labels, **kwargs) -> Dict:
        return self._pos_losses(pos_scores, pos_labels)

    def update_aux_info(self, info_name, info_dict, target):
        """Route a recognizer's feature dict into the aux-info namespace."""
        for k, new_key in self.aux_keys.get(info_name, {}).items():
            assert new_key not in target, f'{new_key} already in target'
            target[new_key] = info_dict[k]
        return target


@HEADS.register_module()
class MoDistPredHead(_AlignBase):
    """One RGB level against one flow level (``flow_source``: 'single' is
    mlvl_ids[1], 'first' level 0, 'concat' the base and rotated flow
    concatenated along time)."""
    flow_source = 'single'

    def __init__(self, rgb_trans_style=None, flow_trans_style=None,
                 flow_source=None, **kwargs):
        super().__init__(**kwargs)
        self.rgb_trans_style = rgb_trans_style or self.rgb_trans_style
        self.flow_trans_style = flow_trans_style or self.flow_trans_style
        self.flow_source = flow_source or self.flow_source
        self._make_trans(self.rgb_trans_style, self.flow_trans_style)

    def forward(self, q_mlvl, q_flow_mlvl, q_aug_flow_mlvl=None, **kwargs):
        x_q = _frames(q_mlvl[self.mlvl_ids[0]])
        if self.flow_source == 'concat' and q_aug_flow_mlvl is not None:
            x_f = torch.cat([q_flow_mlvl[self.mlvl_ids[1]],
                             q_aug_flow_mlvl[self.mlvl_ids[1]]], dim=2)
        elif self.flow_source == 'first':
            x_f = q_flow_mlvl[0]
        else:
            x_f = q_flow_mlvl[self.mlvl_ids[1]]
        x_q = self._trans_rgb(x_q, self.rgb_trans_style)
        x_f = self._trans_flow(_frames(x_f), self.flow_trans_style)
        pos_scores, pos_labels = frame_sim_scores(x_q, x_f, self.T)
        return dict(pos_scores=pos_scores, pos_labels=pos_labels)


@HEADS.register_module()
class MoDistMSEPredHead(MoDistPredHead):
    """Adds the MSE between the projected, normalised features; the two
    terms weighted by ``pred_weights``."""

    def __init__(self, pred_weights=(1.0, 1.0), **kwargs):
        super().__init__(**kwargs)
        self.pred_weights = tuple(pred_weights)

    def forward(self, q_mlvl, q_flow_mlvl, q_aug_flow_mlvl=None, **kwargs):
        x_q = _l2norm(self._trans_rgb(_frames(q_mlvl[self.mlvl_ids[0]]),
                                      self.rgb_trans_style))
        x_f = _l2norm(self._trans_flow(
            _frames(q_flow_mlvl[self.mlvl_ids[1]]), self.flow_trans_style))
        sim = torch.einsum('btc,bsc->bts', x_q, x_f)
        b, t = sim.shape[:2]
        return dict(pos_scores=sim.reshape(b * t, -1) / self.T,
                    pos_labels=torch.arange(t, device=sim.device).repeat(b),
                    pred_rgb=x_q, pred_flow=x_f)

    def loss_mx(self, pos_scores, pos_labels, pred_rgb=None, pred_flow=None,
                **kwargs) -> Dict:
        losses = self._pos_losses(pos_scores, pos_labels)
        losses['loss_pos'] = losses['loss_pos'] * self.pred_weights[0]
        if pred_rgb is not None:
            losses['loss_pred'] = self.pred_weights[1] * torch.mean(
                (pred_rgb - pred_flow) ** 2)
        return losses

    loss = loss_mx


@HEADS.register_module()
class FGMoDistPredHead(_AlignBase):
    """Fine-grained alignment: the RGB level 4x4 average-pooled, the flow
    level projected, one alignment per spatial position."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self._make_trans(flow_style='conv1')

    def forward(self, q_mlvl, q_flow_mlvl, **kwargs):
        x_q = _channels_last(q_mlvl[self.mlvl_ids[0]])
        x_f = self._trans_flow(_channels_last(q_flow_mlvl[self.mlvl_ids[1]]),
                               'conv1')
        sim = _fine_grained_sim(x_q, x_f)
        t = sim.shape[3]
        pos_scores = sim.reshape(-1, sim.shape[-1]) / self.T
        pos_labels = torch.arange(t, device=sim.device).repeat(
            pos_scores.shape[0] // t)
        return dict(pos_scores=pos_scores, pos_labels=pos_labels)


@HEADS.register_module()
class MoDistPredDTHead(MoDistPredHead):
    """The flow features detached."""
    flow_trans_style = 'detach'


@HEADS.register_module()
class MTMoDistPredHead(MoDistPredHead):
    """Aligns against the first flow level."""
    flow_source = 'first'


@HEADS.register_module()
class MoDistv2PosHead(MoDistPredHead):
    """The RGB projection an MLP of two layers."""
    rgb_trans_style = 'mlp2'


@HEADS.register_module()
class MSCLWithAugPosHead(MoDistPredHead):
    """The base and rotated flow concatenated as the targets, the RGB
    projection an MLP of two layers."""
    rgb_trans_style = 'mlp2'
    flow_source = 'concat'


@HEADS.register_module()
class MSCLWithAugSimpleHead(_AlignBase):
    """No alignment: no output, no loss, no routed features."""

    def forward(self, **kwargs):
        return dict()

    def loss(self, **kwargs):
        return dict()

    def update_aux_info(self, info_name, info_dict, target):
        return target


@HEADS.register_module()
class MSCLWithAugAPPosHead(_AlignBase):
    """LMCL plus the prediction of the FRA rotation angle from the RGB and
    rotated-flow embeddings, which the neck appends as the last level
    (MixBaseMoCo). The RGB features must already be projected (no RGB
    projection: ``bkb_channels[0]`` None)."""

    def __init__(self, num_ap=8, **kwargs):
        super().__init__(**kwargs)
        assert self.bkb_channels[0] is None, \
            'AP head requires FPN-projected RGB features'
        self.num_ap = num_ap
        self.ap_fc1 = Dense(128, self.dtype)
        self.ap_fc2 = Dense(num_ap, self.dtype)
        self._make_trans(flow_style='conv1')

    def forward(self, q_mlvl, q_flow_mlvl, q_aug_flow_mlvl, **kwargs):
        q_ap, q_mlvl = q_mlvl[-1], q_mlvl[:-1]
        q_aug_flow_ap = q_aug_flow_mlvl[-1]
        q_flow_mlvl, q_aug_flow_mlvl = q_flow_mlvl[:-1], q_aug_flow_mlvl[:-1]
        ap = F.relu(self.ap_fc1(torch.cat([q_ap, q_aug_flow_ap], dim=-1)))
        ap_scores = self.ap_fc2(ap)
        x_q = _frames(q_mlvl[self.mlvl_ids[0]])
        x_f = _frames(torch.cat([q_flow_mlvl[self.mlvl_ids[1]],
                                 q_aug_flow_mlvl[self.mlvl_ids[1]]], dim=2))
        x_f = self._trans_flow(x_f, 'conv1')
        pos_scores, pos_labels = frame_sim_scores(x_q, x_f, self.T)
        return dict(pos_scores=pos_scores, pos_labels=pos_labels,
                    ap_scores=ap_scores)

    def loss(self, pos_scores, pos_labels, ap_scores=None, ap_labels=None,
             **kwargs) -> Dict:
        losses = self._pos_losses(pos_scores, pos_labels)
        if ap_scores is not None and ap_labels is not None:
            losses['loss_ap'] = self.loss_cls(ap_scores,
                                              torch.as_tensor(
                                                  ap_labels).reshape(-1))
        return losses


@HEADS.register_module()
class MlvlMSCLWithAugPosHead(_AlignBase):
    """LMCL at several pyramid levels: the losses suffixed by the level
    and loss_pos divided by the number of levels.

    The JAX head names every level's projections alike (``trans_rgb``,
    ``trans_flow``), so flax refuses it with more than one level and a
    projection (NameInUseError); the port refuses that case too, since
    there is no reference to hold it to."""

    def __init__(self, mlvl_ids=(0, 1, 2), mlvl_flow_ids=(-1, -1, -1),
                 pool_type='avg', **kwargs):
        super().__init__(mlvl_ids=mlvl_ids, **kwargs)
        self.mlvl_flow_ids = tuple(mlvl_flow_ids)
        self.pool_type = pool_type
        if len(self.mlvl_ids) > 1 and any(
                c is not None for c in self.bkb_channels):
            raise NotImplementedError(
                'MlvlMSCLWithAugPosHead with projections (bkb_channels) at '
                'more than one level: the JAX head reuses the names '
                'trans_rgb / trans_flow at each level and flax refuses it')
        self._make_trans('conv1', 'conv1')

    def _pool(self, x):
        x = x.amax(dim=(3, 4)) if self.pool_type == 'max' else \
            x.mean(dim=(3, 4))
        return x.transpose(1, 2)

    def forward(self, q_mlvl, q_flow_mlvl, q_aug_flow_mlvl=None, **kwargs):
        pos_scores, pos_labels = [], []
        for rgb_id, flow_id in zip(self.mlvl_ids, self.mlvl_flow_ids):
            x_q = self._pool(q_mlvl[rgb_id])
            x_f = q_flow_mlvl[flow_id]
            if q_aug_flow_mlvl is not None:
                x_f = torch.cat([x_f, q_aug_flow_mlvl[flow_id]], dim=2)
            x_q = self._trans_rgb(x_q, 'conv1')
            x_f = self._trans_flow(self._pool(x_f), 'conv1')
            s, lbl = frame_sim_scores(x_q, x_f, self.T)
            pos_scores.append(s)
            pos_labels.append(lbl)
        return dict(pos_scores=pos_scores, pos_labels=pos_labels)

    def loss(self, pos_scores, pos_labels, **kwargs) -> Dict:
        losses = {}
        n = len(self.mlvl_ids)
        for i, (s, lbl) in enumerate(zip(pos_scores, pos_labels)):
            part = self._pos_losses(s, lbl)
            part['loss_pos'] = part['loss_pos'] / n
            losses.update({f'{k}_{i}': v for k, v in part.items()})
        return losses


@HEADS.register_module()
class MAMSCLWithAugPosHead(_AlignBase):
    """Fine-grained LMCL weighted by the motion map: per (b, t) only the
    top ``chosen_rate`` of the positions, by the map average-pooled to the
    feature grid, keep their label; the rest get -1 (ignored)."""

    def __init__(self, chosen_rate=0.2, **kwargs):
        super().__init__(**kwargs)
        self.chosen_rate = chosen_rate
        self._make_trans(flow_style='conv1')

    def forward(self, q_mlvl, q_flow_mlvl, motion_maps=None, **kwargs):
        x_q = _channels_last(q_mlvl[self.mlvl_ids[0]])
        x_f = self._trans_flow(_channels_last(q_flow_mlvl[self.mlvl_ids[1]]),
                               'conv1')
        sim = _fine_grained_sim(x_q, x_f)
        b, hq, wq, t = sim.shape[:4]
        labels = torch.arange(t, device=sim.device).repeat(
            b * hq * wq).reshape(b, hq, wq, t)
        if motion_maps is not None:
            mm = motion_maps
            if mm.dim() == 5:            # NCTHW, one channel
                mm = mm[:, 0]
            mh, mw = mm.shape[2], mm.shape[3]
            mm = mm.reshape(b, t, hq, mh // hq, wq, mw // wq).mean(dim=(3, 5))
            k = max(int(hq * wq * self.chosen_rate), 1)
            flat = mm.reshape(b, t, -1)
            thresh = torch.sort(flat, dim=-1).values[..., -k][..., None]
            keep = torch.movedim((flat >= thresh).reshape(b, t, hq, wq), 1, 3)
            labels = torch.where(keep, labels, -1)
        return dict(pos_scores=sim.reshape(b * hq * wq * t, -1) / self.T,
                    pos_labels=labels.reshape(-1))
