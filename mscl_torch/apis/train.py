"""Model construction and ``train_model`` (port of
``mscl_tpu/apis/train.py``): config -> datasets, loaders, model, SGD and its
lr schedule, the Runner -> resume -> run, on one card (or the CPU when asked
for). The global batch is ``videos_per_gpu`` x 1 card.
"""
from __future__ import annotations

from typing import Dict, Optional, Union

import torch

from ..core import Runner, build_lr_schedule, build_optimizer
from ..datasets import build_dataloader, build_dataset
from ..models import RECOGNIZERS
from ..models.recognizers import build_ema_fn
from ..models.recognizers.moco import KEY_PATTERNS

# key towers follow the query towers by EMA, not by the optimizer
MOCO_FREEZE = KEY_PATTERNS


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """None means the card. Raises when a CUDA device is asked for and
    there is none; the CPU is used only when the caller names it."""
    device = torch.device('cuda' if device is None else device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('mscl_torch runs on a CUDA device and none is '
                           "available; pass device='cpu' to run on the CPU")
    return device


def build_model_from_cfg(model_cfg: Dict, device=None, seed: int = 0,
                         dtype=None):
    """Build a recognizer from its config, initialise it from a
    ``torch.Generator`` seeded with ``seed``, and move it to ``device``.
    A model with a device aug draws it from a generator on ``device``
    seeded with ``seed`` too.

    ``dtype`` (None: float32) is the compute dtype, as the JAX function's:
    parameters, BN statistics and queues stay float32. TF32 is switched off
    for both matmuls and cuDNN convolutions, so a float32 model on the card
    computes what the CPU reference computes.
    """
    device = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dict(model_cfg)
    cls = RECOGNIZERS.get(cfg.pop('type'))
    if cls is None:
        raise KeyError(f'unknown recognizer {model_cfg["type"]}')
    if dtype is not None:
        cfg['dtype'] = dtype
    model = cls(**cfg)
    model.init_weights(torch.Generator().manual_seed(seed))
    if hasattr(model, 'seed_aug'):
        model.seed_aug(seed)
    return model.to(device)


def _plain(cfg_node) -> Dict:
    return cfg_node.to_dict() if hasattr(cfg_node, 'to_dict') \
        else dict(cfg_node)


def train_model(cfg, validate: bool = True, resume_from: Optional[str] = None,
                seed: Optional[int] = None, max_epochs: Optional[int] = None,
                device=None):
    """Build everything from a Config and train; returns (runner, model).

    ``device`` None means the card, and raises without one; the CPU runs
    only when it is named. The model is initialised from ``seed`` (0 when
    None), which also seeds the epoch order and the device aug's generator.
    """
    device = resolve_device(device)
    data = cfg.data
    train_dataset = build_dataset(_plain(data['train']))
    train_loader = build_dataloader(
        train_dataset, videos_per_gpu=data['videos_per_gpu'],
        workers_per_gpu=data.get('workers_per_gpu', 0), num_gpus=1,
        shuffle=True, seed=seed,
        drop_last=data.get('train_dataloader', {}).get('drop_last', True),
        workers_mode=data.get('workers_mode', 'thread'),
        sampler=data.get('sampler'))

    val_loader = None
    if validate and 'val' in data:
        val_dataset = build_dataset(_plain(data['val']))
        val_loader = build_dataloader(
            val_dataset, videos_per_gpu=data['videos_per_gpu'],
            workers_per_gpu=data.get('workers_per_gpu', 0), num_gpus=1,
            shuffle=False,
            drop_last=data.get('val_dataloader', {}).get('drop_last', False))

    model_cfg = _plain(cfg.model)
    if model_cfg.get('type') != 'MSCLWithAug':
        raise NotImplementedError(
            f'train_model trains MSCLWithAug; {model_cfg.get("type")} is not '
            f'ported')
    if (model_cfg.get('train_cfg') or {}).get('ssl_pretrain'):
        raise NotImplementedError('ssl_pretrain surgery comes with the '
                                  'fine-tune slice')
    model = build_model_from_cfg(model_cfg, device=device, seed=seed or 0)

    total_epochs = max_epochs or cfg.get('total_epochs', 1)
    steps_per_epoch = max(len(train_loader), 1)
    lr_schedule = build_lr_schedule(
        dict(cfg.get('lr_config') or {}), cfg.optimizer['lr'],
        total_epochs, steps_per_epoch)
    optimizer = build_optimizer(
        model, dict(cfg.optimizer), lr_schedule,
        grad_clip=(cfg.get('optimizer_config') or {}).get('grad_clip'),
        freeze_patterns=MOCO_FREEZE)

    runner = Runner(model, optimizer, train_loader, cfg,
                    cfg.get('work_dir', './work_dir'), val_loader=val_loader,
                    pre_update_fn=build_ema_fn(model),
                    lr_schedule=lr_schedule, device=device)
    if max_epochs is not None:
        runner.total_epochs = max_epochs
    if resume_from or cfg.get('resume_from'):
        runner.resume(resume_from or cfg.get('resume_from'))
    runner.run()
    return runner, model
