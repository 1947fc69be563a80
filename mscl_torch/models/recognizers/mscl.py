"""MSCLWithAug: the paper's composite model.

Port of ``mscl_tpu/models/recognizers/mscl.py`` ``MSCLWithAug``: the device
augmentation (``aug``, built from the SSL_AUGS registry and drawn from the
model's own generator, the JAX step's 'moco' stream); the RGB tower's
InfoNCE; the concatenated flow split along T into the base and the
FRA-rotated halves, each through the flow tower (the rotated pass does not
enqueue unless update_aug_flow, and its losses get the '_aug' suffix);
the cross-modal InfoNCE of RGB against each flow pass with the other
tower's pre-enqueue queue as negatives; LMCL over the query features.

The flow tower's stem takes 3 channels when the aug visualises the flow
(the colour wheel: SyncMoCoAugmentV5 with visualize, V3, V4) and the raw 2
(u, v) otherwise. ``dtype`` is the compute dtype: train_step casts the
pixels to it before the aug, as the JAX step does, and both towers and the
LMCL head compute in it.
"""
from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from .. import compute_dtype
from ..builder import RECOGNIZERS, build_head, build_ssl_aug
from .base import parse_losses
from .moco import MoCoV2


@RECOGNIZERS.register_module()
class MSCLWithAug(nn.Module):

    def __init__(self, recognizer, recognizer_flow, moco_mx_head, sup_head,
                 im_key='imgs', flow_key='flow_imgs', aux_info=(), aug=None,
                 same_kn=True, update_aug_flow=False,
                 weight_aug_flow=(1.0, 1.0), train_cfg=None, test_cfg=None,
                 dtype=None):
        super().__init__()
        self.dtype = compute_dtype.resolve_dtype(dtype)
        self.aug = build_ssl_aug(dict(aug or dict(type='IdentityAug')))
        self.aug_seed, self._aug_gen = 0, None
        flow_cfg = dict(recognizer_flow)
        flow_cfg['backbone'] = dict(flow_cfg['backbone'])
        flow_cfg['backbone'].setdefault('in_channels',
                                        3 if self.aug.visualize else 2)
        self.recognizer = self._tower(recognizer, self.dtype)
        self.recognizer_flow = self._tower(flow_cfg, self.dtype)
        self.moco_mx_head = build_head(dict(moco_mx_head))
        self.sup_head = build_head(dict(sup_head, dtype=self.dtype))
        self.im_key = im_key
        if not isinstance(flow_key, str):
            raise NotImplementedError('separate base/rotated flow keys are '
                                      'not ported; concatenate along T')
        self.flow_key = flow_key
        self.aux_info = tuple(aux_info)
        self.update_aug_flow = update_aug_flow
        self.weight_aug_flow = tuple(weight_aug_flow)

    @staticmethod
    def _tower(cfg, dtype) -> MoCoV2:
        cfg = dict(cfg)
        cfg.setdefault('dtype', dtype)
        tower = RECOGNIZERS.get(cfg.pop('type'))
        assert tower is not None and issubclass(tower, MoCoV2), tower
        return tower(**cfg)

    def seed_aug(self, seed: int):
        """Restart the aug's draws from seed (on the device of the next
        batch)."""
        self.aug_seed, self._aug_gen = seed, None

    def aug_generator(self, device: torch.device) -> torch.Generator:
        """The aug's generator, made on device from aug_seed at first use
        (and again if the batch moves to another device)."""
        if self._aug_gen is None or self._aug_gen.device != device:
            self._aug_gen = torch.Generator(device=device).manual_seed(
                self.aug_seed)
        return self._aug_gen

    def init_weights(self, gen: torch.Generator):
        self.recognizer.init_weights(gen)
        self.recognizer_flow.init_weights(gen)
        self.sup_head.init_weights(gen)

    def _flow_pair(self, aux_info, suffix):
        """Base and FRA-rotated halves of the flow, concatenated along T."""
        cat = aux_info[f'{self.flow_key}_{suffix}']
        t = cat.shape[2] // 2
        return cat[:, :, :t], cat[:, :, t:]

    def forward_train(self, im_q, im_k, aux_info) -> Dict[str, torch.Tensor]:
        im_q, im_k, aux_info = self.aug(self.aug_generator(im_q.device),
                                        im_q, im_k, aux_info)
        loss_img, im_features = self.recognizer.forward_train(im_q, im_k)
        flow_q, aug_flow_q = self._flow_pair(aux_info, 'q')
        flow_k, aug_flow_k = self._flow_pair(aux_info, 'k')
        loss_base_flow, base_flow_features = \
            self.recognizer_flow.forward_train(flow_q, flow_k)
        loss_aug_flow, aug_flow_features = self.recognizer_flow.forward_train(
            aug_flow_q, aug_flow_k, update_queue=self.update_aug_flow)
        loss_flow = dict(loss_base_flow)
        for k, v in loss_aug_flow.items():
            if k.startswith('loss'):
                assert k in loss_flow
                loss_flow[k + '_aug'] = v * self.weight_aug_flow[0]

        bank = im_features['bank']
        bank_flow = base_flow_features['bank']
        q, key = im_features['q'], im_features['k']
        mx = self.moco_mx_head
        loss_mx = mx.loss(*mx.forward_moco_mx(
            q, key, base_flow_features['q'], base_flow_features['k'], bank,
            bank_flow))
        if self.weight_aug_flow[1] > 0:
            loss_mx.update(mx.loss(*mx.forward_moco_mx(
                q, key, aug_flow_features['q'], aug_flow_features['k'], bank,
                bank_flow), suffix='_aug'))

        aux = dict(aux_info)
        for name, feats in (('im_features', im_features),
                            ('base_flow_features', base_flow_features),
                            ('aug_flow_features', aug_flow_features)):
            aux = self.sup_head.update_aux_info(name, feats, aux)
        aux.update(self.sup_head(**aux))
        loss_sup = self.sup_head.loss(**aux)

        losses: Dict[str, torch.Tensor] = {}
        for part in (loss_img, loss_flow, loss_mx, loss_sup):
            losses.update(part)
        return losses

    def train_step(self, batch):
        """batch[im_key] and batch[flow key] are [q, k] pairs of NCTHW
        tensors, cast to the compute dtype before the aug; returns (total
        loss, log_vars)."""
        fk, dt = self.flow_key, self.dtype
        aux_info = {f'{fk}_q': batch[fk][0].to(dt),
                    f'{fk}_k': batch[fk][1].to(dt)}
        for item in self.aux_info:
            aux_info[item] = batch[item]
        losses = self.forward_train(batch[self.im_key][0].to(dt),
                                    batch[self.im_key][1].to(dt), aux_info)
        return parse_losses(losses)
