"""The long-term feature bank stack: ``LFB``, the FBO heads,
``LFBInferHead`` and ``ACRNHead``.

Port of ``mscl_tpu/models/heads/lfb.py`` (reference models/common/lfb.py,
heads/fbo_head.py, heads/lfb_infer_head.py, heads/misc_head.py):

- ``LFB``: the host-side bank {video_id: {second: [features]}} read from
  each mode's ``lfb_{mode}.pkl``; ``sample_long_term_features`` gives the
  (window_size * K, C) block around a keyframe, up to K features a second
  drawn without replacement, zeros elsewhere. The draws come from the
  ``np.random.Generator`` given (none: one seeded from the global
  ``np.random`` stream, ``core.bbox.host_rng``). ``sample_lfb`` stacks a
  batch's blocks.
- ``NonLocalLayer``, ``FBONonLocal``, ``FBOHead`` ('non_local', 'avg',
  'max'): the RoI's pooled feature (N, C) attends over the long-term
  features (N, L, C); Dense layers on the last axis (``st_feat_conv``,
  ``lt_feat_conv``, ``global_conv``, ``out_conv``), ``ln`` a LayerNorm
  over (S, C) (flax's epsilon 1e-6), dropout 0.2 at the st, lt and each
  layer's output. The head gives [pooled, fbo feature]: C + latent wide
  for 'non_local', 2C for 'avg' and 'max'.
- ``LFBInferHead``: collects each RoI's pooled feature (float16 with
  ``use_half_precision``) under its image key on the host; ``save()``
  writes ``lfb_{dataset_mode}.pkl`` in the bank's layout.
- ``ACRNHead``: the RoI's max-pooled feature tiled over the context map,
  concatenated with its clip's context, through a 1x1x1 and a (1,3,3)
  convolution ('SAME', stride (1, s, s)), each with BN and ReLU, and
  ``num_convs - 1`` more (1,3,3) ones (``conv{i}_conv``, ``conv{i}_bn``;
  the second pair ``conv2.conv``, ``conv2.bn``, as
  ``convert.jax_to_state_dict`` maps JAX's ``conv2_conv``).

Layouts: RoI features channels-last (N, T, h, w, C), as the port's
``SingleRoIExtractor3D`` gives them; ACRN's context NCTHW (B, C, T, H, W),
its output channels-last again. The JAX Dense and Conv layers size
themselves from their first input; the port's take their input widths
from the detector (``in_channels``), which reads them off the backbone,
so a config's ``st_feat_channels``, ``lt_feat_channels`` and ACRN's
``in_channels`` are read as JAX reads them: where the detector gives
none. Names are the JAX tree's.
"""
from __future__ import annotations

import os
import os.path as osp
import pickle
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...core.bbox import host_rng
from ...ops.batch_norm import BatchNorm3d
from .. import compute_dtype
from ..builder import HEADS
from ..weight_init import lecun_normal_
from .base import RateDropout


class LFB:

    def __init__(self, lfb_prefix_path, max_num_sampled_feat=5,
                 window_size=60, lfb_channels=2048,
                 dataset_modes=('train', 'val'), device='cpu', **kwargs):
        self.window_size = window_size
        self.max_num_sampled_feat = max_num_sampled_feat
        self.lfb_channels = lfb_channels
        if isinstance(dataset_modes, str):
            dataset_modes = (dataset_modes,)
        self.lfb: Dict[str, Dict[int, List[np.ndarray]]] = {}
        for mode in dataset_modes:
            with open(osp.join(lfb_prefix_path, f'lfb_{mode}.pkl'),
                      'rb') as f:
                bank = pickle.load(f)
            for vid, secs in bank.items():
                self.lfb.setdefault(vid, {}).update(secs)

    def sample_long_term_features(self, video_id: str, timestamp: int,
                                  rng=None) -> np.ndarray:
        rng = host_rng(rng)
        video_features = self.lfb.get(video_id, {})
        w, k = self.window_size, self.max_num_sampled_feat
        out = np.zeros((w * k, self.lfb_channels), np.float32)
        start = timestamp - w // 2
        for idx, sec in enumerate(range(start, start + w)):
            feats = video_features.get(sec)
            if not feats:
                continue
            n_sampled = min(len(feats), k)
            for j, ri in enumerate(rng.choice(len(feats), n_sampled,
                                              replace=False)):
                out[idx * k + j] = np.asarray(feats[ri], np.float32)
        return out

    def __getitem__(self, img_key: str) -> np.ndarray:
        video_id, timestamp = img_key.split(',')
        return self.sample_long_term_features(video_id, int(timestamp))

    def __len__(self):
        return len(self.lfb)


def sample_lfb(lfb: LFB, img_keys, rng=None) -> np.ndarray:
    """(N, window_size * K, C): each key's block, from one generator."""
    rng = host_rng(rng)
    return np.stack([lfb.sample_long_term_features(
        k.split(',')[0], int(k.split(',')[1]), rng=rng) for k in img_keys])


class _Dense(nn.Linear):
    """flax's Dense: lecun-normal kernel (or zeros), zero bias, in the
    compute dtype."""

    def __init__(self, cin, cout, dtype, zero=False):
        super().__init__(cin, cout)
        self.compute_dtype, self.zero = dtype, zero

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator):
        if self.zero:
            self.weight.zero_()
        else:
            lecun_normal_(self.weight, gen)
        self.bias.zero_()

    def forward(self, x):
        return compute_dtype.linear(self, x, self.compute_dtype)


def _init_children(module, gen):
    for m in module.modules():
        if m is not module and isinstance(m, _Dense):
            m.init_weights(gen)


class NonLocalLayer(nn.Module):

    def __init__(self, st_channels: int, lt_channels: int,
                 latent_channels: int, out_channels: int,
                 num_st_feat: int = 1, use_scale: bool = True,
                 pre_activate: bool = True,
                 pre_activate_with_ln: bool = True,
                 dropout_ratio: float = 0.2,
                 zero_init_out_conv: bool = False,
                 dtype=torch.float32):
        super().__init__()
        c = latent_channels
        self.latent_channels, self.use_scale = c, use_scale
        self.pre_activate = pre_activate
        self.pre_activate_with_ln = pre_activate_with_ln
        self.st_feat_conv = _Dense(st_channels, c, dtype)
        self.lt_feat_conv = _Dense(lt_channels, c, dtype)
        self.global_conv = _Dense(lt_channels, c, dtype)
        self.ln = nn.LayerNorm([num_st_feat,
                                c if pre_activate else out_channels],
                               eps=1e-6)
        self.out_conv = _Dense(c, out_channels, dtype,
                               zero=zero_init_out_conv)
        self.drop = RateDropout(dropout_ratio) if dropout_ratio > 0 \
            else None

    def forward(self, st_feat, lt_feat):
        theta = self.st_feat_conv(st_feat)               # (N, S, c)
        phi = self.lt_feat_conv(lt_feat)                 # (N, L, c)
        g = self.global_conv(lt_feat)
        attn = torch.einsum('nsc,nlc->nsl', theta, phi)
        if self.use_scale:
            attn = attn / (self.latent_channels ** 0.5)
        out = torch.einsum('nsl,nlc->nsc', F.softmax(attn, dim=-1), g)
        if self.pre_activate:
            if self.pre_activate_with_ln:
                out = self.ln(out)
            out = F.relu(out)
        out = self.out_conv(out)
        if not self.pre_activate:
            out = self.ln(out)
        return out if self.drop is None else self.drop(out)


class FBONonLocal(nn.Module):

    def __init__(self, st_feat_channels: int = 2048,
                 lt_feat_channels: int = 2048, latent_channels: int = 512,
                 num_non_local_layers: int = 2,
                 st_feat_dropout_ratio: float = 0.2,
                 lt_feat_dropout_ratio: float = 0.2,
                 pre_activate: bool = True, zero_init_out_conv: bool = False,
                 num_st_feat: int = 1, num_lt_feat: int = 300,
                 dtype=torch.float32):
        super().__init__()
        c = latent_channels
        self.pre_activate = pre_activate
        self.num_non_local_layers = num_non_local_layers
        self.st_feat_conv = _Dense(st_feat_channels, c, dtype)
        self.lt_feat_conv = _Dense(lt_feat_channels, c, dtype)
        self.st_drop = RateDropout(st_feat_dropout_ratio) \
            if st_feat_dropout_ratio > 0 else None
        self.lt_drop = RateDropout(lt_feat_dropout_ratio) \
            if lt_feat_dropout_ratio > 0 else None
        for i in range(num_non_local_layers):
            setattr(self, f'non_local_layer_{i + 1}', NonLocalLayer(
                c, c, c, c, num_st_feat, pre_activate=pre_activate,
                zero_init_out_conv=zero_init_out_conv, dtype=dtype))

    def forward(self, st_feat, lt_feat):
        st = self.st_feat_conv(st_feat)
        lt = self.lt_feat_conv(lt_feat)
        if self.st_drop is not None:
            st = self.st_drop(st)
        if self.lt_drop is not None:
            lt = self.lt_drop(lt)
        for i in range(self.num_non_local_layers):
            st = st + getattr(self, f'non_local_layer_{i + 1}')(st, lt)
            if not self.pre_activate:
                st = F.relu(st)
        return st


def _pool(x, temporal, spatial):
    """(N, T, h, w, C) -> (N, C): the temporal then the spatial pool."""
    x = x.mean(dim=1) if temporal == 'avg' else x.amax(dim=1)
    return x.mean(dim=(1, 2)) if spatial == 'avg' else x.amax(dim=(1, 2))


@HEADS.register_module()
class FBOHead(nn.Module):

    def __init__(self, lfb_cfg=None, fbo_cfg=None,
                 temporal_pool_type: str = 'avg',
                 spatial_pool_type: str = 'max', in_channels=None,
                 dtype=None):
        super().__init__()
        dtype = compute_dtype.resolve_dtype(dtype)
        fbo = dict(fbo_cfg or dict(type='non_local'))
        fbo_type = fbo.pop('type', 'non_local')
        self.temporal_pool_type = temporal_pool_type
        self.spatial_pool_type = spatial_pool_type
        if fbo_type == 'non_local':
            if in_channels is not None:
                fbo.update(st_feat_channels=in_channels,
                           lt_feat_channels=in_channels)
            self.fbo = FBONonLocal(dtype=dtype, **fbo)
            self.out_channels = fbo.get('st_feat_channels', 2048) + \
                fbo.get('latent_channels', 512)
        elif fbo_type in ('avg', 'max'):
            self.fbo = fbo_type
            self.out_channels = 2 * (in_channels or 2048)
        else:
            raise KeyError(fbo_type)

    def init_weights(self, gen: torch.Generator):
        _init_children(self, gen)

    def forward(self, x, lt_feat):
        st = _pool(x, self.temporal_pool_type, self.spatial_pool_type)
        if isinstance(self.fbo, str):
            fbo_feat = lt_feat.mean(dim=1) if self.fbo == 'avg' \
                else lt_feat.amax(dim=1)
        else:
            fbo_feat = self.fbo(st[:, None, :], lt_feat)[:, 0]
        return torch.cat([st, fbo_feat], dim=-1)


@HEADS.register_module()
class LFBInferHead:
    """A host-side collector, no module: the JAX detector passes the RoI
    features through unchanged where a config names it."""

    def __init__(self, lfb_prefix_path, dataset_mode='train',
                 use_half_precision=True, temporal_pool_type='avg',
                 spatial_pool_type='max', **kwargs):
        os.makedirs(lfb_prefix_path, exist_ok=True)
        self.lfb_prefix_path = lfb_prefix_path
        self.dataset_mode = dataset_mode
        self.use_half_precision = use_half_precision
        self.temporal_pool_type = temporal_pool_type
        self.spatial_pool_type = spatial_pool_type
        self.all_features: List[np.ndarray] = []
        self.all_metadata: List[str] = []

    def __call__(self, x, rois, img_metas):
        """x: (N, T, h, w, C) RoI features (a tensor on any device, or
        numpy); rois (N, 5); img_metas: each batch row's {'img_key'}."""
        if isinstance(x, torch.Tensor):
            x = x.detach().cpu().numpy()
        x = np.asarray(x)
        feat = x.mean(axis=1) if self.temporal_pool_type == 'avg' else \
            x.max(axis=1)
        feat = feat.mean(axis=(1, 2)) if self.spatial_pool_type == 'avg' \
            else feat.max(axis=(1, 2))
        if self.use_half_precision:
            feat = feat.astype(np.float16)
        if isinstance(rois, torch.Tensor):
            rois = rois.detach().cpu().numpy()
        for i, ind in enumerate(np.asarray(rois)[:, 0].astype(np.int64)):
            self.all_metadata.append(img_metas[int(ind)]['img_key'])
            self.all_features.append(feat[i])
        return x

    def save(self):
        assert len(self.all_features) == len(self.all_metadata)
        bank: Dict[str, Dict[int, list]] = {}
        for feature, metadata in zip(self.all_features, self.all_metadata):
            video_id, timestamp = metadata.split(',')
            bank.setdefault(video_id, {}).setdefault(
                int(timestamp), []).append(np.squeeze(feature))
        path = osp.join(self.lfb_prefix_path,
                        f'lfb_{self.dataset_mode}.pkl')
        with open(path, 'wb') as f:
            pickle.dump(bank, f)
        return path


def _same_conv(conv: nn.Conv3d, x, dtype):
    """A Conv3d with flax's 'SAME' padding (an odd pixel at the end)."""
    pads = []
    for size, k, s in zip(reversed(x.shape[2:]), reversed(conv.kernel_size),
                          reversed(conv.stride)):
        total = max((-(-size // s) - 1) * s + k - size, 0)
        pads += [total // 2, total - total // 2]
    return compute_dtype.conv(conv, F.pad(x, pads), dtype)


class _Pair(nn.Module):
    """ACRN's second convolution and its BN (``conv2.conv``,
    ``conv2.bn``)."""

    def __init__(self, conv, bn):
        super().__init__()
        self.conv, self.bn = conv, bn


@HEADS.register_module()
class ACRNHead(nn.Module):

    def __init__(self, in_channels: int = 4096, out_channels: int = 2048,
                 stride: int = 1, num_convs: int = 1, dtype=None):
        super().__init__()
        self.compute_dtype = compute_dtype.resolve_dtype(dtype)
        self.num_convs = num_convs
        specs = [(in_channels, (1, 1, 1), (1, 1, 1)),
                 (out_channels, (1, 3, 3), (1, stride, stride))] + \
            [(out_channels, (1, 3, 3), (1, 1, 1))] * (num_convs - 1)
        for i, (cin, kernel, st) in enumerate(specs, 1):
            conv = nn.Conv3d(cin, out_channels, kernel, st, bias=False)
            bn = BatchNorm3d(out_channels)
            if i == 2:
                self.conv2 = _Pair(conv, bn)
            else:
                setattr(self, f'conv{i}_conv', conv)
                setattr(self, f'conv{i}_bn', bn)

    def _layers(self):
        for i in range(1, self.num_convs + 2):
            if i == 2:
                yield self.conv2.conv, self.conv2.bn
            else:
                yield getattr(self, f'conv{i}_conv'), \
                    getattr(self, f'conv{i}_bn')

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator):
        for conv, _ in self._layers():
            lecun_normal_(conv.weight, gen)

    def forward(self, x, feat, rois):
        """x: (N, T, h, w, C) RoI features; feat: (B, C', T, H, W) context;
        rois (N, 5) -> (N, T, H', W', out_channels)."""
        pooled = x.amax(dim=(1, 2, 3))                  # (N, C)
        gfeat = feat[rois[:, 0].to(torch.int64)]        # (N, C', T, H, W)
        tiled = pooled[:, :, None, None, None].expand(
            (-1, -1) + tuple(gfeat.shape[2:]))
        y = torch.cat([tiled, gfeat], dim=1)
        for conv, bn in self._layers():
            y = F.relu(bn(_same_conv(conv, y, self.compute_dtype)))
        return y.permute(0, 2, 3, 4, 1)
