"""Model construction, the SSL checkpoint surgery and ``train_model``
(port of ``mscl_tpu/apis/train.py``): config -> datasets, loaders, model
(and, for a fine-tune config, its backbone from a pretrained encoder), SGD
and its lr schedule, the Runner -> resume -> run, on one card (or the CPU
when asked for). The global batch is ``videos_per_gpu`` x the world size:
in a process group (``parallel/dist.py``) every rank builds the same model
from the same seed, takes rank 0's parameters and buffers, and trains on
its rows of each global batch.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch.nn.parameter import is_lazy

from ..core import Runner, build_lr_schedule, build_optimizer
from ..core.checkpoint import load_checkpoint, model_state_dict
from ..datasets import build_dataloader, build_dataset
from ..models import RECOGNIZERS
from ..models.recognizers import build_ema_fn, init_from_ssl_pretrain
from ..models.recognizers.moco import KEY_PATTERNS
from ..parallel import dist
from ..utils.device import resolve_device

# key towers follow the query towers by EMA, not by the optimizer
MOCO_FREEZE = KEY_PATTERNS


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
    if hasattr(model, 'seed_dropout'):
        model.seed_dropout(seed)
    return model.to(device)


def _is_moco(model_cfg: Dict) -> bool:
    """The MoCo family: key towers by EMA, frozen for the optimizer."""
    return model_cfg.get('type', '') in ('MoCo', 'MoCoV2', 'MSCL',
                                         'MSCLWithAug', 'MoDist')


def apply_ssl_pretrain(model, ssl_cfg: Dict) -> None:
    """Load a pretrained encoder into ``model.backbone`` in place
    (reference base.py:129-203, ``init_from_ssl_pretrain``). The file is a
    checkpoint of the port (the Runner's ``epoch_N.pth``), of the JAX
    package (``epoch_N.ckpt``) or a reference ``.pth``; all hold
    ``recognizer.encoder_q.*`` (the prefix is ``ssl_cfg.backbone.prefix``)
    once read."""
    path = ssl_cfg['pretrained']['filename']
    sd = model_state_dict(load_checkpoint(path))
    prefix = (ssl_cfg.get('backbone') or {}).get('prefix',
                                                 'recognizer.encoder_q')
    if not any(k.startswith(prefix + '.') for k in sd):
        raise KeyError(f'no keys under prefix {prefix + "."!r} in {path} '
                       f'(found e.g. {list(sd)[:3]})')
    model.load_state_dict(init_from_ssl_pretrain(
        model.state_dict(), sd, module_name='backbone', prefix=prefix,
        extras=tuple(ssl_cfg.get('extras', ('fc',))),
        revise_keys=ssl_cfg.get('revise_keys', ()),
        duplicate_keys=ssl_cfg.get('duplicate_keys', ())))


# the localizers mscl_tpu's train_model cannot train as shipped: their
# pipelines give ``raw_feature`` and a ragged ``gt_bbox`` (PEM's
# ``LoadProposals`` up to top_k rows a video), which its collate cannot
# stack (mscl_tpu/datasets/loader.py:41); with even rows BMN's train_step
# reads a ``label_confidence`` that no step makes
# (mscl_tpu/models/localizers/bmn.py:181), and TEM's and PEM's Collect
# meta strings reach the init (mscl_tpu/core/train_loop.py:57)
UNTRAINABLE_LOCALIZERS = ('BMN', 'TEM', 'PEM')


def _plain(cfg_node) -> Dict:
    return cfg_node.to_dict() if hasattr(cfg_node, 'to_dict') \
        else dict(cfg_node)


def train_model(cfg, validate: bool = True, resume_from: Optional[str] = None,
                seed: Optional[int] = None, max_epochs: Optional[int] = None,
                device=None):
    """Build everything from a Config and train; returns (runner, model).

    ``device`` None means the card, and raises without one; the CPU runs
    only when it is named. The model is initialised from ``seed`` (0 when
    None), which also seeds the epoch order and the device aug's and the
    head's dropout generators; then ``model.train_cfg.ssl_pretrain``, if
    set, loads its backbone. The loaders' decode processes are stopped
    when the run ends. A list of train sets (OmniSource) is refused before
    anything is built, and so are BMN, TEM and PEM
    (``UNTRAINABLE_LOCALIZERS``). In a process group the world is the
    group's, and 'cuda' is the rank's card (the current device
    ``init_distributed`` set).
    """
    device = resolve_device(device)
    world, rank = dist.world_size(), dist.rank()
    data = cfg.data
    if isinstance(data['train'], (list, tuple)):
        # the JAX train_model builds data.train with dict(), which fails on
        # a list of sources, and nothing there picks OmniSourceRunner
        raise NotImplementedError(
            f'data.train is a list of {len(data["train"])} sources (an '
            f'OmniSource config): train_model takes one train set, as '
            f'mscl_tpu.apis.train_model does, whose dict() of the list '
            f'fails; OmniSourceRunner is the runner such a list needs')
    model_type = _plain(cfg.model).get('type')
    if model_type in UNTRAINABLE_LOCALIZERS:
        raise NotImplementedError(
            f'{model_type} does not train through train_model: its data '
            f'gives raw features and ragged ground truth (or ragged '
            f'proposals), whose batches mscl_tpu.apis.train_model fails '
            f'to collate, and no step there makes the labels its '
            f'train_step reads; train it as the JAX tests do, the '
            f"model's generate_labels on each batch, then train_step")
    simple_eval = (cfg.get('evaluation') or {}).get('simple', False)
    train_dataset = build_dataset(_plain(data['train']))
    train_loader = build_dataloader(
        train_dataset, videos_per_gpu=data['videos_per_gpu'],
        workers_per_gpu=data.get('workers_per_gpu', 0), num_gpus=world,
        rank=rank, shuffle=True, seed=seed,
        drop_last=data.get('train_dataloader', {}).get('drop_last', True),
        workers_mode=data.get('workers_mode', 'thread'),
        sampler=data.get('sampler'))

    val_loader = val_dataset = None
    if validate and 'val' in data:
        val_dataset = build_dataset(_plain(data['val']))
        val_loader = build_dataloader(
            val_dataset, videos_per_gpu=data['videos_per_gpu'],
            workers_per_gpu=data.get('workers_per_gpu', 0), num_gpus=world,
            rank=rank, shuffle=False, pad_last=not simple_eval,
            drop_last=data.get('val_dataloader', {}).get('drop_last', False))

    model_cfg = _plain(cfg.model)
    is_moco = _is_moco(model_cfg)
    model = build_model_from_cfg(model_cfg, device=device, seed=seed or 0)
    ssl_cfg = (model_cfg.get('train_cfg') or {}).get('ssl_pretrain')
    if ssl_cfg:
        apply_ssl_pretrain(model, dict(ssl_cfg))
    # the ranks built the same model from one seed; rank 0's makes sure
    # (a head's lazy projection, shapeless until its first call, is drawn
    # from a seed taken alike on every rank)
    with torch.no_grad():
        dist.broadcast_([v for v in model.state_dict().values()
                         if not is_lazy(v)], tag='model_init')

    total_epochs = max_epochs or cfg.get('total_epochs', 1)
    steps_per_epoch = max(len(train_loader), 1)
    lr_schedule = build_lr_schedule(
        dict(cfg.get('lr_config') or {}), cfg.optimizer['lr'],
        total_epochs, steps_per_epoch)
    optimizer = build_optimizer(
        model, dict(cfg.optimizer), lr_schedule,
        grad_clip=(cfg.get('optimizer_config') or {}).get('grad_clip'),
        freeze_patterns=MOCO_FREEZE if is_moco else ())

    eval_fn = None
    if val_loader is not None and not simple_eval:
        from .inference import make_eval_fn
        eval_fn = make_eval_fn(model)

    runner = Runner(model, optimizer, train_loader, cfg,
                    cfg.get('work_dir', './work_dir'), val_loader=val_loader,
                    val_dataset=val_dataset,
                    pre_update_fn=build_ema_fn(model) if is_moco else None,
                    lr_schedule=lr_schedule, device=device, eval_fn=eval_fn)
    if max_epochs is not None:
        runner.total_epochs = max_epochs
    try:
        if resume_from or cfg.get('resume_from'):
            runner.resume(resume_from or cfg.get('resume_from'))
        runner.run()
    finally:
        for loader in (train_loader, val_loader):
            if loader is not None:
                loader.shutdown()
    return runner, model
