"""Turn the JAX package's variables into the port's state_dict.

The port names its modules after the JAX tree, with torchvision's layout
where the two differ, so the mapping is mechanical, one path segment at a
time:

  module ``<name>_m``  -> ``<name>``      (recognizer_m -> recognizer)
  ``layer{i}_{j}``     -> ``layer{i}.{j}`` (torchvision stage / block)
  ``conv`` / ``bn``    -> ``0`` / ``1``    inside a VideoResNet (the subtree
                          holding ``stem``), whose ConvBN is the Sequential
                          conv, BN, ReLU; elsewhere (ResNet3d's ConvModule)
                          they keep mmaction's names
  ``conv2_conv`` / ``conv2_bn`` -> ``conv2.conv`` / ``conv2.bn`` (ResNet3d's
                          Bottleneck3d names its conv2 pair bare)
  params ``kernel``    -> ``weight``: conv (T,H,W,Cin,Cout) ->
                          (Cout,Cin,T,H,W),
                          Dense (in,out) -> (out,in)
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
TPNProjMoCo's convs ``proj{i}_0`` / ``proj{i}_1``.

Leaves are read with ``np.asarray``, so JAX arrays work without importing
JAX here. RAFT has its own mapping onto the official RAFT names:
``raft_jax_to_state_dict``.
"""
from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch
from torch import nn

_LEAF = {'params': {'kernel': 'weight', 'scale': 'weight', 'bias': 'bias'},
         'batch_stats': {'mean': 'running_mean', 'var': 'running_var'}}


def _segment(seg: str, convbn: bool = False) -> str:
    if seg in ('conv2_conv', 'conv2_bn'):
        return seg.replace('_', '.')
    if convbn and seg in ('conv', 'bn'):
        return '0' if seg == 'conv' else '1'
    m = re.fullmatch(r'(layer\d+)_(\d+)', seg)
    if m:
        return f'{m.group(1)}.{m.group(2)}'
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
        value = np.transpose(value, (4, 3, 0, 1, 2) if value.ndim == 5
                             else (1, 0))
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


def load_jax_variables(module: nn.Module, variables: Dict) -> None:
    """Load JAX variables into ``module``; every name must match both ways."""
    sd = {k: torch.from_numpy(v) for k, v in
          jax_to_state_dict(variables).items()}
    module.load_state_dict(sd, strict=True)
