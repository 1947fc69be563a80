"""Turn the JAX package's variables into the port's state_dict.

The port names its modules after the JAX tree, with torchvision's layout
where the two differ, so the mapping is mechanical, one path segment at a
time:

  module ``<name>_m``  -> ``<name>``      (recognizer_m -> recognizer)
  ``layer{i}_{j}``     -> ``layer{i}.{j}`` (torchvision stage / block)
  ``conv`` / ``bn``    -> ``0`` / ``1``    (ConvBN is conv, BN, ReLU)
  params ``kernel``    -> ``weight``: conv (T,H,W,Cin,Cout) ->
                          (Cout,Cin,T,H,W),
                          Dense (in,out) -> (out,in)
  params ``scale``     -> ``weight``;  ``bias`` -> ``bias``
  batch_stats ``mean`` / ``var`` -> ``running_mean`` / ``running_var``
  moco_state ``queue``, ``count``, ``queue_ptr``, ``iters`` as they are
  (integers as int64).

Leaves are read with ``np.asarray``, so JAX arrays work without importing
JAX here.
"""
from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch
from torch import nn

_LEAF = {'params': {'kernel': 'weight', 'scale': 'weight', 'bias': 'bias'},
         'batch_stats': {'mean': 'running_mean', 'var': 'running_var'}}


def _segment(seg: str) -> str:
    if seg == 'conv':
        return '0'
    if seg == 'bn':
        return '1'
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


def jax_to_state_dict(variables: Dict) -> Dict[str, np.ndarray]:
    """{'params': ..., 'batch_stats': ..., 'moco_state': ...} (nested
    dicts, any subtree root) -> flat torch state_dict of numpy arrays."""
    out = {}

    def walk(collection, node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(collection, v, path + [k])
            return
        name, value = _leaf(collection, path[-1], np.asarray(node))
        key = '.'.join([_segment(s) for s in path[:-1]] + [name])
        out[key] = np.array(value, order='C')

    for collection, tree in variables.items():
        if collection not in ('params', 'batch_stats', 'moco_state'):
            raise KeyError(f'unknown collection {collection!r}')
        walk(collection, tree, [])
    return out


def load_jax_variables(module: nn.Module, variables: Dict) -> None:
    """Load JAX variables into ``module``; every name must match both ways."""
    sd = {k: torch.from_numpy(v) for k, v in
          jax_to_state_dict(variables).items()}
    module.load_state_dict(sd, strict=True)
