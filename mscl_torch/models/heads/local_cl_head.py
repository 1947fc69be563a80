"""MSCLWithAugPosHeadV2: LMCL, the frame-level RGB/flow alignment loss.

Port of ``mscl_tpu/models/heads/local_cl_head.py``. RGB features
q_mlvl[0] (b, c, t after spatial pooling) against the base-flow and
rotated-flow features concatenated along time (b, c, 2t); optional linear
projections; cosine similarity (b, t, 2t) / T; cross-entropy with labels
arange(t) tiled over the batch, so the t rotated-flow columns are the FRA
negatives. All in the features' dtype, projections in the compute ``dtype``
(the JAX head's flax Dense).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .. import compute_dtype
from ..builder import HEADS, build_loss
from .base import topk_accuracy


@HEADS.register_module()
class MSCLWithAugPosHeadV2(nn.Module):

    def __init__(self, basename='', loss_cls=None, loss_pos=None,
                 num_classes=2, in_channels=128,
                 mlvl_ids: Tuple[int, int] = (0, -1),
                 bkb_channels: Tuple = (512, 128), t=8, T=0.07,
                 aux_keys=None, dtype=None):
        super().__init__()
        self.dtype = compute_dtype.resolve_dtype(dtype)
        self.mlvl_ids = tuple(mlvl_ids)
        self.T = T
        self.aux_keys = aux_keys or {}
        self.loss_pos = build_loss(dict(
            loss_pos or dict(type='CrossEntropyLoss_torch')))
        rgb_ch, flow_ch = bkb_channels
        self.project_rgb = rgb_ch is not None
        if self.project_rgb:
            self.trans_rgb_0 = nn.Linear(rgb_ch, 128)
            self.trans_rgb_1 = nn.Linear(128, 128)
        self.trans_flow = None if flow_ch is None else nn.Linear(flow_ch, 128)

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator):
        """torch Linear default init, drawn from ``gen``."""
        for m in self.modules():
            if isinstance(m, nn.Linear):
                nn.init.kaiming_uniform_(m.weight, a=5 ** 0.5, generator=gen)
                bound = m.in_features ** -0.5
                nn.init.uniform_(m.bias, -bound, bound, generator=gen)

    def forward(self, q_mlvl, q_flow_mlvl, q_aug_flow_mlvl, **kwargs
                ) -> Dict[str, torch.Tensor]:
        x_q = q_mlvl[self.mlvl_ids[0]]
        x_f = torch.cat([q_flow_mlvl[self.mlvl_ids[1]],
                         q_aug_flow_mlvl[self.mlvl_ids[1]]], dim=2)
        x_q = x_q.mean(dim=(3, 4)).transpose(1, 2)     # (b, t, c)
        x_f = x_f.mean(dim=(3, 4)).transpose(1, 2)     # (b, 2t, c)

        def fc(layer, t):
            return compute_dtype.linear(layer, t, self.dtype)
        if self.project_rgb:
            x_q = fc(self.trans_rgb_1, F.relu(fc(self.trans_rgb_0, x_q)))
        if self.trans_flow is not None:
            x_f = fc(self.trans_flow, x_f)
        x_q = F.normalize(x_q, dim=-1, eps=1e-12)
        x_f = F.normalize(x_f, dim=-1, eps=1e-12)
        sim = torch.einsum('btc,bsc->bts', x_q, x_f)
        b, t = sim.shape[:2]
        pos_labels = torch.arange(t, device=sim.device).repeat(b)
        return dict(pos_scores=sim.reshape(b * t, -1) / self.T,
                    pos_labels=pos_labels)

    def loss(self, pos_scores, pos_labels, **kwargs) -> Dict:
        return {'loss_pos': self.loss_pos(pos_scores, pos_labels),
                'top1_acc_pos': topk_accuracy(pos_scores, pos_labels, 1),
                'top5_acc_pos': topk_accuracy(pos_scores, pos_labels, 5)}

    def update_aux_info(self, info_name, info_dict, target):
        """Route a recognizer's feature dict into the aux-info namespace."""
        for k, new_key in self.aux_keys.get(info_name, {}).items():
            assert new_key not in target, f'{new_key} already in target'
            target[new_key] = info_dict[k]
        return target
