"""The flagship MSCLWithAug r18 pretrain configuration and a synthetic batch.

A copy of ``__graft_entry__._mscl_cfg`` / ``_mscl_batch`` (that module
imports JAX) with ``aug=IdentityAug``: the device augmentation
(SyncMoCoAugmentV5) is not ported yet. ``FLAGSHIP_CONFIG`` is the same
recipe as a config file.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from ..config import Config

FLAGSHIP_CONFIG = str(Path(__file__).resolve().parents[2] / 'configs' /
                      'recognition' / 'moco' / 'mscl_r18_cosm_lr2e-2.py')


def load_flagship_config() -> Config:
    """The flagship config file with model.aug set to IdentityAug."""
    cfg = Config.fromfile(FLAGSHIP_CONFIG)
    cfg.merge_from_dict({'model.aug': dict(_delete_=True, type='IdentityAug')})
    return cfg


def flagship_model_cfg(num_frames=8, K=65536, max_iters=1000, dim=128):
    def moco(backbone, dim_in, basename):
        return dict(
            type='MoCoV2', backbone=backbone,
            neck=(dict(type='TPNMoCo', in_channels=[128, 256, 512],
                       out_channels=128,
                       sepc_cfg=dict(in_channels=[128, 128, 128],
                                     out_channels=128, stride=(2, 2, 2),
                                     iBN=False, Pconv_num=2))
                  if basename == '' else dict(type='BaseMoCo')),
            moco_head=dict(type='MoCoHead', basename=basename,
                           loss_cls=dict(type='CrossEntropyLoss_torch',
                                         ignore_index=-1)),
            im_key='imgs', dim_in=dim_in, dim=dim, K=K, m_base=0.994,
            max_iters=max_iters, T=0.07, mlp=True, aux_info=[],
            aug=dict(type='IdentityAug'))

    return dict(
        type='MSCLWithAug',
        recognizer=moco(dict(type='torchvision.r3d_18'), 512, ''),
        recognizer_flow=moco(dict(type='resnet_flow.r2d_18'), 128, 'flow'),
        moco_mx_head=dict(type='MSCLWithAugMxHead', basename='mx',
                          loss_cls=dict(type='CrossEntropyLoss_torch',
                                        ignore_index=-1),
                          same_kn=True, T=0.07),
        sup_head=dict(type='MSCLWithAugPosHeadV2', basename='',
                      loss_pos=dict(type='CrossEntropyLoss_torch',
                                    ignore_index=-1),
                      bkb_channels=(None, None), t=num_frames // 2,
                      T=0.07,
                      aux_keys=dict(
                          im_features=dict(q_mlvl='q_mlvl'),
                          base_flow_features=dict(q_mlvl='q_flow_mlvl'),
                          aug_flow_features=dict(
                              q_mlvl='q_aug_flow_mlvl'))),
        im_key='imgs', flow_key='flow_imgs', aux_info=[],
        update_aug_flow=False, weight_aug_flow=(1.0, 1.0),
        aug=dict(type='IdentityAug'), same_kn=True)


def narrow_flagship_cfg(K=32, dim=32, rgb_width=8, flow_width=2,
                        num_frames=8, max_iters=1000):
    """The flagship recipe with one block per stage and narrow widths, for
    checks at small shapes. The TPN width equals the flow tower's last-stage
    width (flow_width * 8), as the flagship's 128 = 16 * 8 does, so LMCL
    compares like with like."""
    cfg = flagship_model_cfg(num_frames=num_frames, K=K, max_iters=max_iters,
                             dim=dim)
    rgb, flow = cfg['recognizer'], cfg['recognizer_flow']
    tpn = flow_width * 8
    rgb['backbone'] = dict(type='torchvision.r3d_18', layers=(1, 1, 1, 1),
                           base_width=rgb_width)
    rgb['dim_in'] = rgb_width * 8
    rgb['neck'] = dict(type='TPNMoCo',
                       in_channels=[rgb_width * 2, rgb_width * 4,
                                    rgb_width * 8],
                       out_channels=tpn,
                       sepc_cfg=dict(in_channels=[tpn] * 3, out_channels=tpn,
                                     stride=(2, 2, 2), iBN=False,
                                     Pconv_num=2))
    flow['backbone'] = dict(type='resnet_flow.r2d_18', layers=(1, 1, 1, 1),
                            base_width=flow_width)
    flow['dim_in'] = tpn
    return cfg


def flagship_batch(bs, num_frames=8, hw=112, flow_hw=None, seed=0):
    """imgs: 2 x (bs, 3, T, hw, hw) uniform; flow_imgs: 2 x
    (bs, 2, 2T, flow_hw, flow_hw) normal (base half, rotated half)."""
    flow_hw = hw if flow_hw is None else flow_hw
    rng = np.random.default_rng(seed)
    return {
        'imgs': [rng.uniform(size=(bs, 3, num_frames, hw, hw))
                 .astype(np.float32) for _ in range(2)],
        'flow_imgs': [rng.normal(size=(bs, 2, 2 * num_frames, flow_hw,
                                       flow_hw)).astype(np.float32)
                      for _ in range(2)],
    }
