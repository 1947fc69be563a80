"""Checkpoints: save, load, resume, publish.

Port of ``mscl_tpu/core/checkpoint.py`` in ``torch.save`` format. A
checkpoint ``<work_dir>/<prefix>epoch_N.pth`` holds everything the next
step reads, as the JAX package's TrainState does:

  ``state_dict``  the model's parameters and buffers (queues, ``count``,
                  ``queue_ptr``, ``iters``, BN statistics), reference names
  ``optimizer``   the SGD momentum buffers and ``steps`` (the lr schedule
                  reads it)
  ``aug_rng``     the state of the device aug's generator (None before the
                  first batch, or without a device aug)
  ``dropout_rng`` the state of the head's dropout generator (None before
                  the first batch, or without one)
  ``meta``        ``epoch`` and whatever the caller adds

only tensors, numbers, strings and containers of them, so it loads with
``weights_only=True``. ``epoch_N.pth.meta.json`` repeats ``meta``; a file
``latest`` names the newest unprefixed checkpoint.

``load_checkpoint`` also reads a checkpoint of the JAX package
(``epoch_N.ckpt``, ``core/jax_checkpoint.py``): its model's parameters and
buffers, under the port's names, load into a model (fine-tune surgery, the
test and retrieval CLIs); resuming training from it is refused, since its
optimizer and RNG keys have no counterpart in the port's generators.

In a process group (``parallel/dist.py``) the state is replicated, so rank
0 alone writes, and every rank waits at a barrier until the write is done:
a rank may then read what was written.
"""
from __future__ import annotations

import hashlib
import io
import json
import os
import os.path as osp
from typing import Any, Dict, Optional

import torch

from ..parallel import dist
from .jax_checkpoint import JAX_FORMAT, load_jax_checkpoint

FORMAT = 'mscl_torch.checkpoint.v1'


def _to_host(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().clone()
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return tree


def train_state(model, optimizer=None) -> Dict[str, Any]:
    """The model's and optimizer's state, copied to the host."""
    aug = getattr(model, 'aug_state', None)
    dropout = getattr(model, 'dropout_state', None)
    return _to_host({
        'format': FORMAT,
        'state_dict': model.state_dict(),
        'optimizer': None if optimizer is None else optimizer.state_dict(),
        'aug_rng': aug() if aug is not None else None,
        'dropout_rng': dropout() if dropout is not None else None,
    })


def save_checkpoint(state: Optional[Dict[str, Any]], work_dir: str,
                    epoch: int, meta: Optional[Dict] = None,
                    prefix: str = '') -> str:
    """prefix != '' writes an auxiliary checkpoint (the eval hook's
    ``best_<metric>_``, the preemption's ``preempt_``) that does not move
    the 'latest' resume pointer. In a process group only rank 0 writes
    (the others may pass None for ``state``) and all return after the
    write."""
    name = f'{prefix}epoch_{epoch}.pth'
    path = osp.join(work_dir, name)
    if dist.is_main():
        os.makedirs(work_dir, exist_ok=True)
        meta = dict(meta or {}, epoch=epoch)
        torch.save(dict(state, meta=meta), path)
        with open(path + '.meta.json', 'w') as f:
            json.dump(meta, f)
        if not prefix:
            with open(osp.join(work_dir, 'latest'), 'w') as f:
                f.write(name)
    dist.barrier()
    return path


def load_checkpoint(path: str) -> Dict[str, Any]:
    """A checkpoint of the port as saved; a JAX ``.ckpt`` as
    ``load_jax_checkpoint`` reads it; any other file (a reference ``.pth``)
    as its ``state_dict``. A directory means its 'latest'."""
    if osp.isdir(path):
        with open(osp.join(path, 'latest')) as f:
            path = osp.join(path, f.read().strip())
    if path.endswith('.ckpt'):
        return load_jax_checkpoint(path)
    ckpt = torch.load(path, map_location='cpu', weights_only=True)
    if isinstance(ckpt, dict) and ckpt.get('format') == FORMAT:
        return ckpt
    return ckpt.get('state_dict', ckpt) if isinstance(ckpt, dict) else ckpt


def load_meta(path: str) -> Dict[str, Any]:
    meta_path = path + '.meta.json'
    if osp.exists(meta_path):
        with open(meta_path) as f:
            return json.load(f)
    return {}


def latest_checkpoint(work_dir: str) -> Optional[str]:
    latest = osp.join(work_dir, 'latest')
    if not osp.exists(latest):
        return None
    with open(latest) as f:
        return osp.join(work_dir, f.read().strip())


def model_state_dict(ckpt: Dict[str, Any]) -> Dict[str, Any]:
    """The model's parameters and buffers of what ``load_checkpoint``
    read."""
    return ckpt['state_dict'] if ckpt.get('format') in (FORMAT, JAX_FORMAT) \
        else ckpt


def restore_model_state(model, ckpt: Dict[str, Any]) -> None:
    """Load only the model's parameters and buffers, from a checkpoint of
    the port, of the JAX package or a reference ``state_dict`` (the port's
    module names are the reference's)."""
    sd = model_state_dict(ckpt)
    model.load_state_dict(sd, strict=True)


def restore_train_state(model, optimizer, ckpt: Dict[str, Any]) -> None:
    """Everything ``train_state`` saved, back in place; a reference
    ``state_dict`` restores the model only. A JAX ``.ckpt`` is refused."""
    if ckpt.get('format') == JAX_FORMAT:
        raise NotImplementedError(
            f'{ckpt["path"]} is a checkpoint of the JAX package: the port '
            f'does not resume training from it (its optimizer state and RNG '
            f'keys do not map onto the port\'s generators). Fine-tune from '
            f'it (model.train_cfg.ssl_pretrain) or test it instead, or '
            f'resume from a checkpoint of the port')
    restore_model_state(model, ckpt)
    if ckpt.get('format') != FORMAT:
        return
    if optimizer is not None and ckpt.get('optimizer') is not None:
        optimizer.load_state_dict(ckpt['optimizer'])
    if hasattr(model, 'set_aug_state'):
        model.set_aug_state(ckpt.get('aug_rng'))
    if hasattr(model, 'set_dropout_state'):
        model.set_dropout_state(ckpt.get('dropout_rng'))


def publish_model(in_path: str, out_path: str) -> str:
    """Strip the optimizer state and append a content hash
    (parity: tools/deployment/publish_model.py)."""
    ckpt = load_checkpoint(in_path)
    ckpt = dict(ckpt, optimizer=None) if ckpt.get('format') == FORMAT \
        else ckpt
    buf = io.BytesIO()
    torch.save(ckpt, buf)
    blob = buf.getvalue()
    sha = hashlib.sha256(blob).hexdigest()[:8]
    root, ext = osp.splitext(out_path)
    final = f'{root}-{sha}{ext or ".pth"}'
    with open(final, 'wb') as f:
        f.write(blob)
    return final
