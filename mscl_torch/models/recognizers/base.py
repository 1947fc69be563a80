"""Loss parsing and the SSL checkpoint surgery (port of
``mscl_tpu/models/recognizers/base.py``).

The surgery (reference mmaction recognizers/base.py:129-203) loads a
pretrained encoder (``recognizer.encoder_q.*`` of an MSCL checkpoint) into
a fine-tune model's ``backbone``. It works on flat torch state dicts with
dotted keys, the reference's own form, so the reference's ``revise_keys``
and ``duplicate_keys`` regexes mean here what they mean there; the JAX
package applies them to '/'-joined flax paths (``recognizer_m/encoder_q/
layer1_0/...``), where a pattern written for the dotted names may not
match. A state dict holds both the weights and the BN running statistics,
so one graft covers what JAX grafts as two collections. The port's BN
keeps no ``num_batches_tracked``: a reference checkpoint's counters have no
target and are left out, as any source key without a target is.
"""
from __future__ import annotations

import re
from typing import Dict, List, Sequence, Tuple

import torch


def parse_losses(losses: Dict[str, torch.Tensor]
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean each entry for logging; the total sums the keys holding 'loss'."""
    log_vars = {name: value.mean() for name, value in losses.items()}
    loss = sum(v for k, v in log_vars.items() if 'loss' in k)
    log_vars['loss'] = loss
    return loss, log_vars


def get_ssl_state_dict(state_dict: Dict[str, torch.Tensor], revise_keys=(),
                       duplicate_keys=(), prefix: str = ''
                       ) -> Dict[str, torch.Tensor]:
    """Rename the keys of a checkpoint by ``revise_keys`` (pattern,
    replacement), add the copies ``duplicate_keys`` make, then keep the
    keys under ``prefix`` with the prefix stripped (reference
    base.py:167-188)."""
    items = dict(state_dict)
    for pattern, replacement in revise_keys:
        items = {re.sub(pattern, replacement, k): v for k, v in items.items()}
    for pattern, replacement in duplicate_keys:
        items.update({re.sub(pattern, replacement, k): v
                      for k, v in items.items() if re.search(pattern, k)})
    if prefix:
        pref = prefix + '.'
        items = {k[len(pref):]: v for k, v in items.items()
                 if k.startswith(pref)}
    return items


def graft(target: Dict[str, torch.Tensor], source: Dict[str, torch.Tensor],
          extras: Sequence[str] = ()
          ) -> Tuple[Dict[str, torch.Tensor], List[str]]:
    """Each key of ``target`` takes the source's tensor of that key, cast
    to the target's dtype and device (a non-strict load, reference
    base.py:190-203). Keys that contain one of ``extras`` (e.g. 'fc') keep
    the target's tensor; a key the source lacks or holds in another shape
    keeps it too and is reported. Returns (the new target, what was not
    loaded)."""
    out, missing = dict(target), []
    for k, v in target.items():
        if any(e in k for e in extras):
            continue
        if k not in source:
            missing.append(k)
        elif tuple(source[k].shape) != tuple(v.shape):
            missing.append(f'{k} (shape mismatch)')
        else:
            out[k] = source[k].to(device=v.device, dtype=v.dtype)
    return out, missing


def init_from_ssl_pretrain(state_dict: Dict[str, torch.Tensor],
                           ckpt_state_dict: Dict[str, torch.Tensor],
                           module_name: str = 'backbone',
                           prefix: str = 'recognizer.encoder_q',
                           extras: Sequence[str] = ('fc',),
                           revise_keys=(), duplicate_keys=()
                           ) -> Dict[str, torch.Tensor]:
    """A copy of a fine-tune model's ``state_dict`` whose ``module_name``
    part holds the checkpoint's ``prefix`` part (reference
    base.py:129-203); what was not loaded is printed."""
    src = get_ssl_state_dict(ckpt_state_dict, revise_keys, duplicate_keys,
                             prefix)
    pref = module_name + '.'
    tgt = {k[len(pref):]: v for k, v in state_dict.items()
           if k.startswith(pref)}
    if not tgt:
        raise KeyError(f'{module_name} not in the model')
    new_tgt, missing = graft(tgt, src, extras)
    if missing:
        print(f'[ssl_pretrain] {len(missing)} params not loaded '
              f'(first few: {missing[:5]})')
    out = dict(state_dict)
    out.update({pref + k: v for k, v in new_tgt.items()})
    return out
