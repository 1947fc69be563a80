"""Turn the JAX package's variables into the port's state_dict.

The port names its modules after the JAX tree, with torchvision's layout
where the two differ, so the mapping is mechanical, one path segment at a
time:

  module ``<name>_m``  -> ``<name>``      (recognizer_m -> recognizer)
  ``layer{i}_{j}``     -> ``layer{i}.{j}`` (torchvision stage / block);
                          ``layer{i}_{j}_local`` -> ``layer{i}_local.{j}``
                          (ResNet3dSlowOnly_TwoR5's second last stage)
  ``conv`` / ``bn``    -> ``0`` / ``1``    inside a VideoResNet (the subtree
                          holding ``stem``), whose ConvBN is the Sequential
                          conv, BN, ReLU; elsewhere (ResNet3d's ConvModule)
                          they keep mmaction's names
  ``conv2_conv`` / ``conv2_bn`` -> ``conv2.conv`` / ``conv2.bn`` (ResNet3d's
                          Bottleneck3d names its conv2 pair bare)
  params ``kernel``    -> ``weight``: conv3d (T,H,W,Cin,Cout) ->
                          (Cout,Cin,T,H,W), conv2d (H,W,Cin,Cout) ->
                          (Cout,Cin,H,W), conv1d (K,Cin,Cout) ->
                          (Cout,Cin,K) (a grouped conv's Cin is its
                          group's, as torch lays it), Dense (in,out) ->
                          (out,in)
  params ``scale``     -> ``weight``;  ``bias`` -> ``bias``
  batch_stats ``mean`` / ``var`` -> ``running_mean`` / ``running_var``
  moco_state ``queue``, ``count``, ``queue_ptr``, ``iters`` as they are
  (integers as int64).

The ablation family's modules keep the flax names, so the same rules
cover them: the alignment heads' Dense projections ``trans_rgb``,
``trans_rgb_0`` / ``trans_rgb_1``, ``trans_flow``, ``ap_fc1`` / ``ap_fc2``
(kernels transposed as any Dense); TemporalModulation's grouped conv
``tpn/tm_{i}/conv`` (its (3, 1, 1, C/32, C) kernel -> (C, C/32, 3, 1, 1),
torch's grouped layout); SEPC's integrated BN ``sepc/pconv3d_{j}/ibn``;
TPNProjMoCo's convs ``proj{i}_0`` / ``proj{i}_1``; the reid heads' raw
``fc_cls_kernel`` (in, classes) and ``fc_cls_bias``, kept as they are.

So do the frame-based recognizers: the 2D ResNets' ``ConvBN2d`` keeps
mmaction's ``conv`` / ``bn`` (``layer{i}.{j}.conv1.conv``), a non-local
block ``layer{i}_{j}_nonlocal`` (``g``, ``theta``, ``phi``, ``conv_out``,
``bn_out``) keeps its name; MobileNetV2's ``expand`` / ``depthwise``
(``conv``, ``bn``) and ``project`` / ``project_bn``, the depthwise kernel
(3,3,1,C) -> (C,1,3,3); TIN's ``tin/offset_net`` (``conv`` (3,C,1) ->
(1,C,3), ``fc1``, ``fc2``) and ``tin/weight_net/conv``; TANet's
``tam`` (``g_fc1``, ``g_bn``, ``g_fc2``, ``l_conv1``, ``l_bn``,
``l_conv2``); C3D's ``conv1a`` .. ``conv5b`` (with biases); the TRN head's
``fc_cls``, ``scale{k}_fc1`` / ``_fc2`` and ``fusion_fc1`` / ``_fc2``.

So does the 3D zoo: SlowFast's ``fast_path`` / ``slow_path`` (ResNet3d
names) and its bias-free ``lateral_{i}`` convs; CSN's ``conv2_ip`` and
depthwise ``conv2_dw`` ((3,3,3,1,C) -> (C,1,3,3,3)) with its bare
``conv2_bn`` (-> ``conv2.bn``, as Bottleneck3d's); ResNet3dLayer's
``layer{n}_{j}``; R(2+1)D's ``stem_s`` / ``stem_t`` and each block's
``conv{n}_s`` (``conv``, ``bn``), ``conv{n}_t`` and ``bn{n}``; the R3D
adapter's VideoResNet (``stem.0`` / ``stem.1``); X3D's ``conv1_s``,
depthwise ``conv1_t`` and ``conv2``, the SE convs ``se.fc1`` / ``se.fc2``
with their biases, ``downsample`` / ``downsample_bn``, ``conv5`` and
``bn5``; S3D's ``conv_s`` / ``conv_t`` and Inception branches; TimeSformer's
``patch_embed`` (a conv2d with a bias), its Dense kernels transposed,
LayerNorm ``scale`` -> ``weight`` and the raw ``pos_embed``,
``cls_token`` and ``time_embed`` kept as they are; TPN's
``spatial_{i}_{j}``, ``tm_{i}``, ``level_fusion_td`` / ``_bu``
(``downsample_{i}``, ``fusion``), ``downsample_op_{i}``,
``pyramid_fusion``, ``aux_conv``, ``aux_bn`` and ``aux_fc``.

Leaves are read with ``np.asarray``, so JAX arrays work without importing
JAX here. RAFT has its own mapping onto the official RAFT names:
``raft_jax_to_state_dict``; PWC-Lite, whose modules keep the flax names,
``pwclite_jax_to_state_dict``.
"""
from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch
from torch import nn

_LEAF = {'params': {'kernel': 'weight', 'scale': 'weight', 'bias': 'bias',
                    'fc_cls_kernel': 'fc_cls_kernel',
                    'fc_cls_bias': 'fc_cls_bias', 'pos_embed': 'pos_embed',
                    'cls_token': 'cls_token', 'time_embed': 'time_embed'},
         'batch_stats': {'mean': 'running_mean', 'var': 'running_var'}}


# a flax kernel's axes in torch's order: conv3d (T,H,W,Cin,Cout), conv2d
# (H,W,Cin,Cout), conv1d (K,Cin,Cout) -> (Cout,Cin,...); Dense (in,out) ->
# (out,in). A grouped conv's Cin is the group's, in both.
_KERNEL_AXES = {5: (4, 3, 0, 1, 2), 4: (3, 2, 0, 1), 3: (2, 1, 0),
                2: (1, 0)}


def _segment(seg: str, convbn: bool = False) -> str:
    if seg in ('conv2_conv', 'conv2_bn'):
        return seg.replace('_', '.')
    if convbn and seg in ('conv', 'bn'):
        return '0' if seg == 'conv' else '1'
    m = re.fullmatch(r'(layer\d+)_(\d+)(_local)?', seg)
    if m:
        return f'{m.group(1)}{m.group(3) or ""}.{m.group(2)}'
    if seg.endswith('_m'):
        return seg[:-2]
    return seg


def _leaf(collection: str, name: str, value: np.ndarray):
    if collection == 'moco_state':
        if np.issubdtype(value.dtype, np.integer):
            value = value.astype(np.int64)
        return name, value
    if name not in _LEAF[collection]:
        raise KeyError(f'unknown {collection} leaf {name!r}')
    if name == 'kernel':
        value = np.transpose(value, _KERNEL_AXES[value.ndim])
    return _LEAF[collection][name], value


def _leaves(node, path=()):
    """(path, leaf as numpy) of a nested dict, depth first."""
    if isinstance(node, dict):
        for k, v in node.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, np.asarray(node)


def _module_leaves(node, segs=(), convbn=False):
    """(the port's module path, leaf name, leaf as numpy) of a nested dict,
    depth first; ``convbn`` from a VideoResNet's subtree down."""
    convbn = convbn or 'stem' in node
    for k, v in node.items():
        if isinstance(v, dict):
            yield from _module_leaves(v, segs + (_segment(k, convbn),),
                                      convbn)
        else:
            yield segs, k, np.asarray(v)


def jax_to_state_dict(variables: Dict) -> Dict[str, np.ndarray]:
    """{'params': ..., 'batch_stats': ..., 'moco_state': ...} (nested
    dicts, any subtree root) -> flat torch state_dict of numpy arrays."""
    out = {}
    for collection, tree in variables.items():
        if collection not in ('params', 'batch_stats', 'moco_state'):
            raise KeyError(f'unknown collection {collection!r}')
        for segs, leaf, value in _module_leaves(tree):
            name, value = _leaf(collection, leaf, value)
            out['.'.join(segs + (name,))] = np.array(value, order='C')
    return out


def _raft_keys(path):
    """A flax RAFT module path -> the official state_dict prefixes it fills.
    RAFT has a real conv named ``conv`` (``update_block/encoder/conv``), so
    the r3d ``_segment`` rule (conv -> 0, bn -> 1) does not apply here."""
    segs = []
    for seg in path:
        if seg in ('bn', 'gn'):             # _Norm's inner module
            continue
        m = re.fullmatch(r'(layer\d+)_(\d+)', seg)
        segs.append(f'{m.group(1)}.{m.group(2)}' if m else
                    {'downsample': 'downsample.0', 'mask_conv1': 'mask.0',
                     'mask_conv2': 'mask.2'}.get(seg, seg))
    keys = ['.'.join(segs)]
    if segs[-1] == 'norm3':                 # the official downsample.1 too
        keys.append('.'.join(segs[:-1] + ['downsample.1']))
    return keys


def raft_jax_to_state_dict(variables: Dict) -> Dict[str, np.ndarray]:
    """Flax RAFT variables ({'params', 'batch_stats'}) -> the port's RAFT
    state_dict (the official names): conv kernels HWIO -> OIHW, BN scale ->
    weight, mean/var -> running_mean/var (with num_batches_tracked 0)."""
    out = {}
    for collection, tree in variables.items():
        if collection not in ('params', 'batch_stats'):
            raise KeyError(f'unknown collection {collection!r}')
        for path, value in _leaves(tree):
            name = _LEAF[collection][path[-1]]
            if path[-1] == 'kernel':
                value = np.transpose(value, (3, 2, 0, 1))
            for key in _raft_keys(path[:-1]):
                out[f'{key}.{name}'] = np.array(value, order='C')
                if name == 'running_mean':
                    out[f'{key}.num_batches_tracked'] = np.array(0, np.int64)
    return out


def pwclite_jax_to_state_dict(variables: Dict) -> Dict[str, np.ndarray]:
    """Flax PWC-Lite variables ({'params'}) -> the port's PWC-Lite
    state_dict: the module path as it is, conv kernels HWIO -> OIHW."""
    out = {}
    for path, value in _leaves(variables['params']):
        if path[-1] == 'kernel':
            value = np.transpose(value, (3, 2, 0, 1))
        out['.'.join(path[:-1] + (_LEAF['params'][path[-1]],))] = \
            np.array(value, order='C')
    return out


def load_jax_variables(module: nn.Module, variables: Dict) -> None:
    """Load JAX variables into ``module``; every name must match both ways."""
    sd = {k: torch.from_numpy(v) for k, v in
          jax_to_state_dict(variables).items()}
    module.load_state_dict(sd, strict=True)
