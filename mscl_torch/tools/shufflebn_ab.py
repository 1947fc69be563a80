"""ShuffleBN A/B: global-batch BN against the per-group ShuffleBN.

    python -m mscl_torch.tools.shufflebn_ab [--steps N] [--batch N]
        [--out PATH] [--device cuda|cpu]

Port of ``tools/analysis/shufflebn_ab.py``: on synthetic videos whose class
is the motion direction of a bright square, a slim MoCoV2 tower
(``ab.tiny3d``, MoCoAugmentV2, K = 256) is pretrained twice from the same
seed, data and schedule, with shuffle_bn=0 (the key BN over the global
batch) and shuffle_bn=4 (a permutation of the key batch, then four groups
with their own BN statistics: DDP's ShuffleBN at world size 4). It records
each run's loss at every step and the kNN retrieval R@1/R@5 of the held-out
half from the pooled query-encoder features, and writes them as the JAX
tool's JSON. The batches are the JAX tool's (numpy from seed 0); the aug's
draws come from the model's generator. It runs on the card; ``--device
cpu`` runs it on the CPU.
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Optional, Sequence

import numpy as np
import torch

from ..apis import MOCO_FREEZE, build_model_from_cfg, resolve_device
from ..core import build_lr_schedule, build_optimizer, make_train_step
from ..models.recognizers import build_ema_fn
from .ablation_ordering import register_tiny3d


def make_videos(n_per_class=16, t=8, hw=32, seed=0):
    """Class = motion direction of a bright square over noise."""
    rng = np.random.default_rng(seed)
    dirs = [(2, 0), (-2, 0), (0, 2), (0, -2)]
    clips, labels = [], []
    for cls, (dx, dy) in enumerate(dirs):
        for _ in range(n_per_class):
            x0 = rng.integers(8, hw - 16)
            y0 = rng.integers(8, hw - 16)
            base = rng.uniform(0, 0.3, size=(hw, hw, 3))
            frames = []
            for i in range(t):
                f = base + rng.normal(scale=0.02, size=(hw, hw, 3))
                xx = int(np.clip(x0 + dx * i, 0, hw - 8))
                yy = int(np.clip(y0 + dy * i, 0, hw - 8))
                f[yy:yy + 8, xx:xx + 8] += 0.6
                frames.append(np.clip(f, 0, 1))
            clips.append(np.stack(frames))      # (t, hw, hw, 3)
            labels.append(cls)
    return (np.asarray(clips, np.float32),
            np.asarray(labels, np.int64))


def model_cfg(shuffle_bn, steps, batch):
    return dict(
        type='MoCoV2', backbone=dict(type='ab.tiny3d'),
        neck=dict(type='BaseMoCo'),
        moco_head=dict(type='MoCoHead',
                       loss_cls=dict(type='CrossEntropyLoss_torch',
                                     ignore_index=-1)),
        im_key='imgs', dim_in=128, dim=32, K=256, m_base=0.99,
        max_iters=steps * batch, T=0.07, mlp=True, aux_info=[],
        aug=dict(type='MoCoAugmentV2', crop_size=32), shuffle_bn=shuffle_bn)


def run(shuffle_bn, clips, labels, steps, batch, device, seed=0):
    """One pretraining run; its losses and retrieval recalls."""
    register_tiny3d('ab.tiny3d')
    n = len(clips)
    train_idx, test_idx = np.arange(n)[::2], np.arange(n)[1::2]
    model = build_model_from_cfg(model_cfg(shuffle_bn, steps, batch),
                                 device=device, seed=seed)
    lr = build_lr_schedule(dict(policy='CosineAnnealing', min_lr=0), 0.05,
                           1, steps)
    opt = build_optimizer(
        model, dict(type='SGD', lr=0.05, momentum=0.9, weight_decay=1e-4),
        lr, grad_clip=dict(max_norm=40), freeze_patterns=MOCO_FREEZE)
    rng = np.random.default_rng(seed)

    def batch_at():
        idx = rng.choice(train_idx, batch, replace=False)
        qk = []
        for shift in (0, 1):
            # temporal-shift positive pair: same clip, offset crop
            sel = clips[idx]
            if shift:
                sel = np.roll(sel, 2, axis=1)
            qk.append(torch.from_numpy(np.ascontiguousarray(
                np.transpose(sel, (0, 4, 1, 2, 3)))).to(device))
        return {'imgs': qk}

    batch_at()      # the JAX tool's init draws one batch first
    step = make_train_step(model, opt, build_ema_fn(model))
    losses = [float(step(batch_at())['loss']) for _ in range(steps)]

    model.eval()
    with torch.no_grad():
        x = torch.from_numpy(np.ascontiguousarray(
            np.transpose(clips, (0, 4, 1, 2, 3)))).to(device)
        f = model.encoder_q(x)
        f = f[-1] if isinstance(f, list) else f
        all_feats = f.mean(dim=(2, 3, 4)).cpu().numpy()
    centered = all_feats - all_feats[train_idx].mean(0)
    normed = centered / np.maximum(
        np.linalg.norm(centered, axis=1, keepdims=True), 1e-8)
    order = np.argsort(-(normed[test_idx] @ normed[train_idx].T), axis=1)
    recalls = {}
    for k in (1, 5):
        hit = [(labels[train_idx[order[i, :k]]] == labels[test_idx[i]]).any()
               for i in range(len(test_idx))]
        recalls[f'R@{k}'] = float(np.mean(hit))
    return dict(losses=losses, **recalls)


def parse_args(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--steps', type=int, default=60)
    p.add_argument('--batch', type=int, default=16)
    p.add_argument('--out', default='work_dirs/shufflebn_ab.json')
    p.add_argument('--device', default='cuda',
                   help="'cuda' (the default) or 'cpu'")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None):
    """Both runs; returns what it writes."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    clips, labels = make_videos()
    out = {}
    for name, g in (('global_bn', 0), ('shuffle_bn4', 4)):
        print(f'=== {name} ===', flush=True)
        out[name] = run(g, clips, labels, args.steps, args.batch, device)
        print(f'{name}: final_loss={out[name]["losses"][-1]:.4f} '
              f'R@1={out[name]["R@1"]:.3f} R@5={out[name]["R@5"]:.3f}',
              flush=True)
    if os.path.dirname(args.out):
        os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, 'w') as f:
        json.dump(out, f, indent=1)
    print(f'wrote {args.out}')
    return out


if __name__ == '__main__':
    main()
