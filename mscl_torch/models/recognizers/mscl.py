"""MSCLWithAug, MSCL and MoDist: the paper's composite model and its
ablations.

Port of ``mscl_tpu/models/recognizers/mscl.py``. ``MSCLWithAug``: the
device augmentation (``aug``, built from the SSL_AUGS registry and drawn
from the model's own generator, the JAX step's 'moco' stream); the RGB
tower's InfoNCE; the flow split into the base and the FRA-rotated passes
(concatenated along T under one ``flow_key``, or under a list of two keys),
each through the flow tower (the rotated pass does not enqueue unless
update_aug_flow, and its losses get the '_aug' suffix), or both as one
forward at a batch of 2B with ``batch_flow_passes`` (joint BN statistics,
``MoCoBase.forward_train_pair``); the cross-modal InfoNCE of RGB against
each flow pass with the other tower's pre-enqueue queue as negatives; LMCL
through ``sup_head`` (any head of the registry) over the features its
``aux_keys`` route. ``MSCL``: no FRA, one flow pass under ``flow_img_key``,
LMCL against the base flow only. ``MoDist``: the two towers and the
cross-modal InfoNCE, no LMCL. Either tower is a MoCo (fixed momentum) or a
MoCoV2 (annealed), whose own aug must be IdentityAug: the composite runs
the aug. A tower's ShuffleBN draws its permutation from the composite's aug
generator, after the aug's draws. The cross-modal head is
``MSCLWithAugMxHead`` (InfoNCE) or ``MSCLWithAugMSFMxHead`` (mean shift);
``MSCLWithAugDistillMxHead`` is refused by name (``check_mx_head``).

The flow tower's stem takes 3 channels when the aug visualises the flow
(the colour wheel: SyncMoCoAugmentV5 with visualize, V3, V4) and the raw 2
(u, v) otherwise. ``dtype`` is the compute dtype of both towers and the
LMCL head. MSCLWithAug's train_step (and MSCL's, inherited) casts the
pixels to it before the aug, as the JAX step does; MoDist's does not, as
the JAX one does not.
"""
from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from .. import compute_dtype
from ..builder import RECOGNIZERS, build_head, build_ssl_aug
from .base import parse_losses
from .moco import AugGenerator, MoCoBase


def check_identity_aug(aug):
    """Inside a composite the composite runs the aug, so a tower's own would
    never run: it must be IdentityAug."""
    if aug is not None and dict(aug).get('type') != 'IdentityAug':
        raise NotImplementedError(
            f"a tower inside MSCLWithAug has the aug {dict(aug).get('type')}, "
            "which would not run; use dict(type='IdentityAug') (the "
            "composite runs its own aug)")


def check_mx_head(cfg):
    """MSCLWithAugDistillMxHead cannot run in the JAX recognizers: its
    forward_moco_mx returns four values where they unpack three
    (mscl_tpu/models/recognizers/mscl.py:139,145,222,279), and its loss
    needs a loss_kl they do not pass; so there is nothing to hold it to
    here."""
    if dict(cfg).get('type') == 'MSCLWithAugDistillMxHead':
        raise NotImplementedError(
            'MSCLWithAugDistillMxHead is not a moco_mx_head of MSCLWithAug, '
            'MSCL or MoDist: its forward_moco_mx returns four values (the '
            'logits, the label and loss_kl) where the JAX recognizers unpack '
            'three, and its loss needs loss_kl; use it as a head alone, or '
            'MSCLWithAugMxHead / MSCLWithAugMSFMxHead')


class _TwoTowers(AugGenerator, nn.Module):
    """The RGB and flow towers, the aug and the cross-modal head."""

    def __init__(self, recognizer, recognizer_flow, moco_mx_head,
                 im_key='imgs', aux_info=(), aug=None, dtype=None):
        super().__init__()
        self.dtype = compute_dtype.resolve_dtype(dtype)
        self.aug = build_ssl_aug(dict(aug or dict(type='IdentityAug')))
        flow_cfg = dict(recognizer_flow)
        flow_cfg['backbone'] = dict(flow_cfg['backbone'])
        flow_cfg['backbone'].setdefault('in_channels',
                                        3 if self.aug.visualize else 2)
        self.recognizer = self._tower(recognizer, self.dtype)
        self.recognizer_flow = self._tower(flow_cfg, self.dtype)
        check_mx_head(moco_mx_head)
        self.moco_mx_head = build_head(dict(moco_mx_head))
        self.im_key = im_key
        self.aux_info = tuple(aux_info)

    @staticmethod
    def _tower(cfg, dtype) -> MoCoBase:
        cfg = dict(cfg)
        cfg.setdefault('dtype', dtype)
        check_identity_aug(cfg.get('aug'))
        tower = RECOGNIZERS.get(cfg.pop('type'))
        assert tower is not None and issubclass(tower, MoCoBase), tower
        return tower(**cfg)

    def init_weights(self, gen: torch.Generator):
        self.recognizer.init_weights(gen)
        self.recognizer_flow.init_weights(gen)

    def _cross_modal(self, im_features, flow_features, bank_flow,
                     suffix='') -> Dict[str, torch.Tensor]:
        """RGB against a flow pass, each with the other tower's queue."""
        mx = self.moco_mx_head
        return mx.loss(*mx.forward_moco_mx(
            im_features['q'], im_features['k'], flow_features['q'],
            flow_features['k'], im_features['bank'], bank_flow),
            suffix=suffix)


@RECOGNIZERS.register_module()
class MSCLWithAug(_TwoTowers):

    def __init__(self, recognizer, recognizer_flow, moco_mx_head, sup_head,
                 im_key='imgs', flow_key='flow_imgs', aux_info=(), aug=None,
                 same_kn=True, update_aug_flow=False,
                 weight_aug_flow=(1.0, 1.0), train_cfg=None, test_cfg=None,
                 dtype=None, batch_flow_passes=False):
        super().__init__(recognizer, recognizer_flow, moco_mx_head, im_key,
                         aux_info, aug, dtype)
        self.sup_head = build_head(dict(sup_head, dtype=self.dtype))
        self.flow_keys = (tuple(flow_key) if isinstance(flow_key,
                                                        (list, tuple))
                          else (flow_key,))
        self.update_aug_flow = update_aug_flow
        self.weight_aug_flow = tuple(weight_aug_flow)
        self.batch_flow_passes = batch_flow_passes

    def init_weights(self, gen: torch.Generator):
        super().init_weights(gen)
        self.sup_head.init_weights(gen)

    def _flow_pair(self, aux_info, suffix):
        """The base and FRA-rotated flow: the halves along T of the one
        flow key, or the two keys' tensors."""
        if len(self.flow_keys) == 1:
            cat = aux_info[f'{self.flow_keys[0]}_{suffix}']
            t = cat.shape[2] // 2
            return cat[:, :, :t], cat[:, :, t:]
        return tuple(aux_info[f'{k}_{suffix}'] for k in self.flow_keys[:2])

    def _lmcl(self, aux_info, **features) -> Dict[str, torch.Tensor]:
        """The sup head over the features its aux_keys route."""
        aux = dict(aux_info)
        for name, feats in features.items():
            aux = self.sup_head.update_aux_info(name, feats, aux)
        aux.update(self.sup_head(**aux))
        return self.sup_head.loss(**aux)

    def forward_train(self, im_q, im_k, aux_info) -> Dict[str, torch.Tensor]:
        gen = self.aug_generator(im_q.device)
        im_q, im_k, aux_info = self.aug(gen, im_q, im_k, aux_info)
        loss_img, im_features = self.recognizer.forward_train(im_q, im_k,
                                                              gen=gen)
        flow_q, aug_flow_q = self._flow_pair(aux_info, 'q')
        flow_k, aug_flow_k = self._flow_pair(aux_info, 'k')
        flow = self.recognizer_flow
        if self.batch_flow_passes:
            (loss_base_flow, base_flow_features), \
                (loss_aug_flow, aug_flow_features) = flow.forward_train_pair(
                    flow_q, flow_k, aug_flow_q, aug_flow_k,
                    update_queue_b=self.update_aug_flow, gen=gen)
        else:
            loss_base_flow, base_flow_features = flow.forward_train(
                flow_q, flow_k, gen=gen)
            loss_aug_flow, aug_flow_features = flow.forward_train(
                aug_flow_q, aug_flow_k, update_queue=self.update_aug_flow,
                gen=gen)
        loss_flow = dict(loss_base_flow)
        for k, v in loss_aug_flow.items():
            if k.startswith('loss'):
                assert k in loss_flow
                loss_flow[k + '_aug'] = v * self.weight_aug_flow[0]

        bank_flow = base_flow_features['bank']
        loss_mx = self._cross_modal(im_features, base_flow_features,
                                    bank_flow)
        if self.weight_aug_flow[1] > 0:
            loss_mx.update(self._cross_modal(im_features, aug_flow_features,
                                             bank_flow, suffix='_aug'))
        loss_sup = self._lmcl(aux_info, im_features=im_features,
                              base_flow_features=base_flow_features,
                              aug_flow_features=aug_flow_features)

        losses: Dict[str, torch.Tensor] = {}
        for part in (loss_img, loss_flow, loss_mx, loss_sup):
            losses.update(part)
        return losses

    def train_step(self, batch):
        """batch[im_key] and batch[each flow key] are [q, k] pairs of NCTHW
        tensors, cast to the compute dtype before the aug; returns (total
        loss, log_vars)."""
        dt = self.dtype
        aux_info = {}
        for fk in self.flow_keys:
            aux_info[f'{fk}_q'] = batch[fk][0].to(dt)
            aux_info[f'{fk}_k'] = batch[fk][1].to(dt)
        for item in self.aux_info:
            aux_info[item] = batch[item]
        losses = self.forward_train(batch[self.im_key][0].to(dt),
                                    batch[self.im_key][1].to(dt), aux_info)
        return parse_losses(losses)


@RECOGNIZERS.register_module()
class MSCL(MSCLWithAug):
    """MSCL without FRA: one flow pass over the flow under
    ``flow_img_key``, the cross-modal loss against it, LMCL against its
    features only."""

    def __init__(self, *args, flow_img_key='flow_imgs', **kwargs):
        super().__init__(*args, **kwargs)
        self.flow_img_key = flow_img_key

    def forward_train(self, im_q, im_k, aux_info) -> Dict[str, torch.Tensor]:
        gen = self.aug_generator(im_q.device)
        im_q, im_k, aux_info = self.aug(gen, im_q, im_k, aux_info)
        loss_img, im_features = self.recognizer.forward_train(im_q, im_k,
                                                              gen=gen)
        loss_flow, flow_features = self.recognizer_flow.forward_train(
            aux_info[f'{self.flow_img_key}_q'],
            aux_info[f'{self.flow_img_key}_k'], gen=gen)
        loss_mx = self._cross_modal(im_features, flow_features,
                                    flow_features['bank'])
        loss_sup = self._lmcl(aux_info, im_features=im_features,
                              base_flow_features=flow_features)
        losses: Dict[str, torch.Tensor] = {}
        for part in (loss_img, loss_flow, loss_mx, loss_sup):
            losses.update(part)
        return losses


@RECOGNIZERS.register_module()
class MoDist(_TwoTowers):
    """The RGB and flow towers with the cross-modal InfoNCE only."""

    def __init__(self, recognizer, recognizer_flow, moco_mx_head,
                 im_key='imgs', flow_key='flow_imgs', aux_info=(), aug=None,
                 same_kn=True, train_cfg=None, test_cfg=None, dtype=None):
        super().__init__(recognizer, recognizer_flow, moco_mx_head, im_key,
                         aux_info, aug, dtype)
        self.flow_key = flow_key

    def forward_train(self, im_q, im_k, aux_info) -> Dict[str, torch.Tensor]:
        gen = self.aug_generator(im_q.device)
        im_q, im_k, aux_info = self.aug(gen, im_q, im_k, aux_info)
        loss_img, im_features = self.recognizer.forward_train(im_q, im_k,
                                                              gen=gen)
        loss_flow, flow_features = self.recognizer_flow.forward_train(
            aux_info[f'{self.flow_key}_q'], aux_info[f'{self.flow_key}_k'],
            gen=gen)
        losses = dict(loss_img)
        losses.update(loss_flow)
        losses.update(self._cross_modal(im_features, flow_features,
                                        flow_features['bank']))
        return losses

    def train_step(self, batch):
        """As MSCLWithAug's, without the cast: the aug runs on the pixels
        as the batch holds them (the towers cast at their first layer)."""
        fk = self.flow_key
        aux_info = {f'{fk}_q': batch[fk][0], f'{fk}_k': batch[fk][1]}
        for item in self.aux_info:
            aux_info[item] = batch[item]
        losses = self.forward_train(batch[self.im_key][0],
                                    batch[self.im_key][1], aux_info)
        return parse_losses(losses)
