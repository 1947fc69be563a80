"""Ablation-ordering experiment: does the motion machinery do anything?

    python -m mscl_torch.tools.ablation_ordering --arm ARM [--scale tiny|full]
        [--steps N] [--batch N] [--seed N] [--n-per-class N]
        [--out-dir DIR] [--device cuda|cpu]

Port of ``tools/analysis/ablation_ordering.py`` (the Round-5 experiment):
five arms are pretrained on a synthetic benchmark whose appearance is a
perfect instance shortcut and whose class is the motion direction of a
square (analytic flow), then the query encoder is evaluated downstream:

  moco        MoCoV2, the RGB tower alone
  modist      + the flow tower and the cross-modal InfoNCE (MoDist)
  mscl_nofra  + LMCL (MoDistv2PosHead), one flow pass (MSCL)
  mscl        MSCLWithAug: FRA, base and rotated flow passes
  mscl_nomds  MSCLWithAug with uniform temporal sampling instead of MDS

Downstream (the query encoder's pooled features, no fine-tuning): motion
retrieval R@1/R@5 of the direction (test against train), a 4-way linear
probe, and appearance retrieval (a video's static clip against every
video's moving clip). Scales: tiny (32 px, T = 4, batch 16, K = 256,
float32, the ``abl.tiny3d`` backbone) and full (112 px, T = 8, batch 32,
K = 2048, bfloat16, r3d_18 + TPNMoCo/SEPC and r2d_18).

The host draws are the JAX tool's, numpy from ``--seed`` in the same order
(the data from seed 100), so the batches are its batches; each step's
batch is assembled on the device from the videos held there. The device
aug's draws come from the model's generator (seed ``--seed``), not from
JAX's streams. SGD (lr 0.05, cosine to 0, momentum 0.9, weight decay 1e-4,
the clip at 40) with the key side frozen and the EMA, through the port's
``core``. Writes ``{out_dir}/{arm}_{scale}_s{seed}.json`` with the JAX
tool's keys (``platform`` is the device type). It runs on the card;
``--device cpu`` runs it on the CPU.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from functools import partial
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..apis import MOCO_FREEZE, build_model_from_cfg, resolve_device
from ..core import build_lr_schedule, build_optimizer, make_train_step
from ..models import BACKBONES
from ..models.backbones.video_resnet import VideoResNet
from ..models.recognizers import build_ema_fn

ARMS = ('moco', 'modist', 'mscl_nofra', 'mscl', 'mscl_nomds')
L = 16          # frames per video
W = 8           # active (moving) window length
DIRS4 = [(1, 0), (-1, 0), (0, 1), (0, -1)]


# ------------------------------------------------------------ dataset
def make_videos(n_per_class, hw, T, seed):
    """Appearance-rich, motion-sparse videos + analytic flow + MDS index.

    Returns dict with rgb (N, L, hw, hw, 3) f32 in [0, 1], flow
    (N, L, hw, hw, 2) f32, labels (N,), chosen (list of offset arrays,
    weight > median), best/worst (max-/min-motion-weight clip offset per
    video).
    """
    rng = np.random.default_rng(seed)
    sq = hw // 4
    v = max(2, hw // 16)
    n_off = L - T + 1
    rgb, flow, labels = [], [], []
    for cls, (ux, uy) in enumerate(DIRS4):
        dx, dy = ux * v, uy * v
        for _ in range(n_per_class):
            # background: low-frequency per-video texture
            grid = rng.uniform(0, 0.45, size=(8, 8, 3)).astype(np.float32)
            reps = -(-hw // 8)
            bg = np.kron(grid, np.ones((reps, reps, 1),
                                       np.float32))[:hw, :hw]
            color = rng.uniform(0.55, 1.0, size=3).astype(np.float32)
            a = int(rng.integers(0, L - W + 1))   # active window start
            # start position such that the whole trajectory stays
            # in-bounds (no clipping -> the analytic flow stays exact)
            lo_x = max(0, -dx * (W - 1))
            hi_x = hw - sq - max(0, dx * (W - 1))
            lo_y = max(0, -dy * (W - 1))
            hi_y = hw - sq - max(0, dy * (W - 1))
            x0 = int(rng.integers(lo_x, hi_x + 1))
            y0 = int(rng.integers(lo_y, hi_y + 1))
            fr = np.empty((L, hw, hw, 3), np.float32)
            fl = np.zeros((L, hw, hw, 2), np.float32)
            for t in range(L):
                k = np.clip(t - a, 0, W - 1)      # steps moved so far
                x, y = x0 + dx * k, y0 + dy * k
                img = bg + rng.normal(scale=0.02,
                                      size=(hw, hw, 3)).astype(np.float32)
                img[y:y + sq, x:x + sq] = color
                fr[t] = np.clip(img, 0, 1)
                if a <= t < a + W - 1:            # moving t -> t+1
                    fl[t, y:y + sq, x:x + sq] = (dx, dy)
            rgb.append(fr)
            flow.append(fl)
            labels.append(cls)
    rgb = np.stack(rgb)
    flow = np.stack(flow)
    labels = np.asarray(labels, np.int64)
    # MDS: per-offset motion weight, chosen = weight > median
    w = np.stack([np.abs(flow[:, o:o + T]).mean(axis=(1, 2, 3, 4))
                  for o in range(n_off)], axis=1)       # (N, n_off)
    med = np.median(w, axis=1, keepdims=True)
    chosen = [np.nonzero(w[i] > med[i])[0] for i in range(len(labels))]
    chosen = [c if len(c) else np.array([int(np.argmax(w[i]))])
              for i, c in enumerate(chosen)]
    return dict(rgb=rgb, flow=flow, labels=labels, chosen=chosen,
                best=w.argmax(axis=1), worst=w.argmin(axis=1),
                n_off=n_off)


def sample_pair_offsets(rng, data, vid, T, mds):
    """(q, k) clip offsets: MDS + temporal-shift positive pair (reference
    TemporalShiftChosenSampleFrames) or plain uniform + shift
    (TemporalShiftSampleFrames)."""
    n_off = data['n_off']
    if mds:
        chosen = data['chosen'][vid]
        q = chosen[0]
        for _ in range(10):                     # rejection sampling
            cand = int(rng.integers(0, n_off))
            if cand in chosen:
                q = cand
                break
        shift = int(rng.integers(-T, T + 1))
        k = int(chosen[np.abs(chosen - (q + shift)).argmin()])
    else:
        q = int(rng.integers(0, n_off))
        k = int(np.clip(q + rng.integers(-T, T + 1), 0, n_off - 1))
    return q, k


def fra_rotate(flow, angle):
    """Flow Rotation Augmentation: rotate every (u, v) vector."""
    c, s = np.cos(angle), np.sin(angle)
    u, v = flow[..., 0], flow[..., 1]
    return np.stack([c * u - s * v, s * u + c * v], axis=-1)


# ------------------------------------------------------------- models
def register_tiny3d(name='abl.tiny3d'):
    """The tools' slim 3D tower (``abl.tiny3d``; shufflebn_ab's
    ``ab.tiny3d``): one basic block a stage, 16 wide, the flow stem."""
    if name not in BACKBONES:
        BACKBONES.register_module(
            name=name,
            module=partial(VideoResNet, block='basic',
                           conv_makers=('simple3d',) * 4,
                           layers=(1, 1, 1, 1), stem='flow_basic',
                           base_width=16))


def _towers(scale, T, K, steps, batch, hw):
    """The towers, heads and aug every arm composes from, so that the only
    difference between arms is the loss machinery."""
    max_iters = steps * batch
    if scale == 'full':
        rgb_bb = dict(type='torchvision.r3d_18')
        rgb_neck = dict(type='TPNMoCo', in_channels=[128, 256, 512],
                        out_channels=128,
                        sepc_cfg=dict(in_channels=[128, 128, 128],
                                      out_channels=128, stride=(2, 2, 2),
                                      iBN=False, Pconv_num=2))
        flow_bb = dict(type='resnet_flow.r2d_18')
        dim_in_rgb, dim_in_flow, dim = 512, 128, 128
        bkb_channels = (None, None)
    else:
        register_tiny3d()
        rgb_bb = flow_bb = dict(type='abl.tiny3d')
        rgb_neck = dict(type='BaseMoCo')
        dim_in_rgb, dim_in_flow, dim = 128, 128, 32
        bkb_channels = (16, 128)

    def moco(backbone, neck, dim_in, basename):
        return dict(
            type='MoCoV2', backbone=backbone, neck=neck,
            moco_head=dict(type='MoCoHead', basename=basename,
                           loss_cls=dict(type='CrossEntropyLoss_torch',
                                         ignore_index=-1)),
            im_key='imgs', dim_in=dim_in, dim=dim, K=K, m_base=0.99,
            max_iters=max_iters, T=0.07, mlp=True, aux_info=[],
            aug=dict(type='IdentityAug'))

    aug = dict(type='SyncMoCoAugmentV5', crop_size=hw,
               sync_level=('batch', 'batch'), t=(T, T),
               flow_suffix='flow_imgs', weak_aug=(False, False),
               visualize=True)
    mx_head = dict(type='MSCLWithAugMxHead', basename='mx',
                   loss_cls=dict(type='CrossEntropyLoss_torch',
                                 ignore_index=-1),
                   same_kn=True, T=0.07)
    sup_head = dict(type='MSCLWithAugPosHeadV2', basename='',
                    loss_pos=dict(type='CrossEntropyLoss_torch',
                                  ignore_index=-1),
                    bkb_channels=bkb_channels, t=T // 2, T=0.07,
                    aux_keys=dict(
                        im_features=dict(q_mlvl='q_mlvl'),
                        base_flow_features=dict(q_mlvl='q_flow_mlvl'),
                        aug_flow_features=dict(q_mlvl='q_aug_flow_mlvl')))
    return (moco(rgb_bb, rgb_neck, dim_in_rgb, ''),
            moco(flow_bb, dict(type='BaseMoCo'), dim_in_flow, 'flow'),
            mx_head, sup_head, aug)


def arm_cfg(arm, scale, T, K, steps, batch, hw):
    """The model config of an arm (the JAX tool's ``build_arm``)."""
    rgb, flw, mx_head, sup_head, aug = _towers(scale, T, K, steps, batch, hw)
    if arm == 'moco':
        return dict(rgb, aug=aug)               # composite-level aug
    if arm == 'modist':
        return dict(type='MoDist', recognizer=rgb, recognizer_flow=flw,
                    moco_mx_head=mx_head, im_key='imgs',
                    flow_key='flow_imgs', aux_info=[], aug=aug,
                    same_kn=True)
    if arm == 'mscl_nofra':
        # one flow pass: the LMCL head must not expect the rotated flow.
        # At tiny scale the flow tower's last level has t=1, so align
        # against flow level 0 there (the JAX tool's choice).
        sup_head = dict(sup_head, type='MoDistv2PosHead',
                        loss_pos=sup_head['loss_pos'],
                        mlvl_ids=(0, -1) if scale == 'full' else (0, 0),
                        aux_keys=dict(
                            im_features=dict(q_mlvl='q_mlvl'),
                            base_flow_features=dict(
                                q_mlvl='q_flow_mlvl')))
        return dict(type='MSCL', recognizer=rgb, recognizer_flow=flw,
                    moco_mx_head=mx_head, sup_head=sup_head,
                    im_key='imgs', flow_key='flow_imgs',
                    flow_img_key='flow_imgs', aux_info=[], aug=aug,
                    same_kn=True)
    return dict(type='MSCLWithAug', recognizer=rgb,            # mscl(_nomds)
                recognizer_flow=flw, moco_mx_head=mx_head,
                sup_head=sup_head, im_key='imgs', flow_key='flow_imgs',
                aux_info=[], update_aug_flow=False,
                weight_aug_flow=(1.0, 1.0), aug=aug, same_kn=True)


# ---------------------------------------------------------- batching
def sample_batch_idx(rng, data, train_idx, arm, batch, T):
    """One batch's (vids, offsets, FRA angles), drawn on the host in the
    JAX tool's order: the videos, each video's offset pair, the two
    branches' angles."""
    mds = arm != 'mscl_nomds'
    vids = rng.choice(train_idx, batch, replace=False)
    offs = np.asarray([sample_pair_offsets(rng, data, v, T, mds)
                       for v in vids], np.int32)          # (B, 2)
    angs = None
    if arm in ('mscl', 'mscl_nomds'):                     # FRA double pass
        angs = np.asarray([(0.2 + 0.2 * int(rng.integers(0, 8))) * np.pi
                           for _ in range(2)], np.float32)
    return vids.astype(np.int32), offs, angs


def make_batch(rng, data, train_idx, arm, batch, T):
    """One training batch in the model's NCTHW layout, made on the host
    (the JAX tool's reference for the device assembly): q/k the
    temporal-shift pair, the flow clips beside their RGB clips, FRA arms
    with [base, rotated] concatenated along T."""
    vids, offs, angs = sample_batch_idx(rng, data, train_idx, arm, batch, T)
    out = {'imgs': [], 'flow_imgs': []}
    for branch in (0, 1):
        im = np.stack([data['rgb'][v, o:o + T]
                       for v, o in zip(vids, offs[:, branch])])
        out['imgs'].append(np.transpose(im, (0, 4, 1, 2, 3)))
        if arm != 'moco':
            fl = np.stack([data['flow'][v, o:o + T]
                           for v, o in zip(vids, offs[:, branch])])
            if angs is not None:
                fl = np.concatenate(
                    [fl, fra_rotate(fl, float(angs[branch]))],
                    axis=1).astype(np.float32)
            out['flow_imgs'].append(np.transpose(fl, (0, 4, 1, 2, 3)))
    if arm == 'moco':
        del out['flow_imgs']
    return out


def assemble_batch(drgb, dflow, vids, offs, angs, arm, T):
    """make_batch's batch, gathered on the device from the videos held
    there (drgb, dflow: (N, L, H, W, C)) and the step's indices; the FRA
    rotation in float64 and rounded once, as make_batch computes it, so
    the two agree bitwise."""
    dev = drgb.device
    vids = torch.as_tensor(vids, dtype=torch.long, device=dev)
    offs = torch.as_tensor(offs, dtype=torch.long, device=dev)
    tt = torch.arange(T, device=dev)
    out = {'imgs': []}
    if arm != 'moco':
        out['flow_imgs'] = []
    for branch in (0, 1):
        fidx = offs[:, branch, None] + tt                 # (B, T)
        im = drgb[vids[:, None], fidx]                    # (B, T, H, W, 3)
        out['imgs'].append(im.permute(0, 4, 1, 2, 3).contiguous())
        if arm != 'moco':
            fl = dflow[vids[:, None], fidx]               # (B, T, H, W, 2)
            if angs is not None:
                a = float(angs[branch])
                c, s = np.cos(a), np.sin(a)
                u, v = fl[..., 0].double(), fl[..., 1].double()
                rot = torch.stack([c * u - s * v, s * u + c * v], dim=-1)
                fl = torch.cat([fl, rot.float()], dim=1)
            out['flow_imgs'].append(fl.permute(0, 4, 1, 2, 3).contiguous())
    return out


# ---------------------------------------------------------------- eval
@torch.no_grad()
def eval_features(model, data, T, arm, device, chunk=32):
    """The query encoder's pooled features (eval mode) for the max- and
    min-motion clip of every video."""
    enc = model.encoder_q if arm == 'moco' else model.recognizer.encoder_q
    was_training = model.training
    model.eval()

    def run(offsets):
        clips = np.stack([data['rgb'][i, o:o + T]
                          for i, o in enumerate(offsets)])
        outs = []
        for i in range(0, len(clips), chunk):
            x = torch.from_numpy(np.ascontiguousarray(np.transpose(
                clips[i:i + chunk], (0, 4, 1, 2, 3)))).to(device)
            f = enc(x)
            f = f[-1] if isinstance(f, list) else f
            outs.append(f.mean(dim=(2, 3, 4)).float().cpu().numpy())
        return np.concatenate(outs)

    out = run(data['best']), run(data['worst'])
    model.train(was_training)
    return out


def knn_retrieval(f_test, y_test, f_train, y_train, ks=(1, 5)):
    mu = f_train.mean(0)
    a = f_test - mu
    b = f_train - mu
    a /= np.maximum(np.linalg.norm(a, axis=1, keepdims=True), 1e-8)
    b /= np.maximum(np.linalg.norm(b, axis=1, keepdims=True), 1e-8)
    order = np.argsort(-(a @ b.T), axis=1)
    return {f'R@{k}': float(np.mean([(y_train[order[i, :k]] ==
                                      y_test[i]).any()
                                     for i in range(len(y_test))]))
            for k in ks}


def linear_probe(f_train, y_train, f_test, y_test, n_cls=4, steps=500,
                 lr=0.5, wd=1e-4, device=None):
    """Multinomial logistic regression on frozen features by full-batch
    gradient descent (the JAX tool's protocol), on ``device`` (None: the
    card)."""
    device = resolve_device(device)
    mu, sd = f_train.mean(0), f_train.std(0) + 1e-6
    xtr = torch.from_numpy((f_train - mu) / sd).to(device)
    xte = torch.from_numpy((f_test - mu) / sd).to(device)
    ytr = torch.from_numpy(np.asarray(y_train)).to(device)
    w = torch.zeros(f_train.shape[1], n_cls, device=device,
                    requires_grad=True)
    b = torch.zeros(n_cls, device=device, requires_grad=True)
    rows = torch.arange(len(ytr), device=device)
    for _ in range(steps):
        ll = F.log_softmax(xtr @ w + b, dim=1)
        loss = -ll[rows, ytr].mean() + wd * (w ** 2).sum()
        gw, gb = torch.autograd.grad(loss, (w, b))
        with torch.no_grad():
            w -= lr * gw
            b -= lr * gb
    with torch.no_grad():
        pred = torch.argmax(xte @ w + b, dim=1).cpu().numpy()
    return float((pred == y_test).mean())


def downstream(model, data, T, arm, train_idx, test_idx, device):
    """Motion retrieval, the linear probe and appearance retrieval."""
    f_best, f_worst = eval_features(model, data, T, arm, device)
    labels, n = data['labels'], len(data['labels'])
    return dict(
        motion=knn_retrieval(f_best[test_idx], labels[test_idx],
                             f_best[train_idx], labels[train_idx]),
        probe_acc=linear_probe(f_best[train_idx], labels[train_idx],
                               f_best[test_idx], labels[test_idx],
                               device=device),
        instance_R1=knn_retrieval(f_worst[test_idx], test_idx, f_best,
                                  np.arange(n), ks=(1,))['R@1'])


# ---------------------------------------------------------------- main
def parse_args(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--arm', required=True, choices=list(ARMS))
    p.add_argument('--scale', default='tiny', choices=['tiny', 'full'])
    p.add_argument('--steps', type=int, default=None)
    p.add_argument('--batch', type=int, default=None)
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--n-per-class', type=int, default=24)
    p.add_argument('--out-dir', default='work_dirs/ablation')
    p.add_argument('--device', default='cuda',
                   help="'cuda' (the default) or 'cpu'")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None,
         on_step: Optional[Callable[[int, float, float], None]] = None):
    """Train and evaluate one arm; returns what it writes. ``on_step(s,
    seconds, loss)`` is called after each step with its wall time (the
    step waits for its loss, as the JAX tool's does) and its loss."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    full = args.scale == 'full'
    hw, T = (112, 8) if full else (32, 4)
    batch = args.batch or (32 if full else 16)
    steps = args.steps or (400 if full else 300)
    K = 2048 if full else 256
    dtype = torch.bfloat16 if full else torch.float32

    data = make_videos(args.n_per_class, hw, T, seed=100)  # shared data
    n = len(data['labels'])
    train_idx = np.arange(n)[::2]
    test_idx = np.arange(n)[1::2]
    rng = np.random.default_rng(args.seed)

    model = build_model_from_cfg(arm_cfg(args.arm, args.scale, T, K, steps,
                                         batch, hw),
                                 device=device, seed=args.seed, dtype=dtype)
    lr = build_lr_schedule(dict(policy='CosineAnnealing', min_lr=0), 0.05,
                           1, steps)
    opt = build_optimizer(
        model, dict(type='SGD', lr=0.05, momentum=0.9, weight_decay=1e-4),
        lr, grad_clip=dict(max_norm=40), freeze_patterns=MOCO_FREEZE)

    init_metrics = downstream(model, data, T, args.arm, train_idx, test_idx,
                              device)
    print(f'[{args.arm}] random-init: {init_metrics}', flush=True)

    step = make_train_step(model, opt, build_ema_fn(model))
    drgb = torch.from_numpy(data['rgb']).to(device)
    dflow = None if args.arm == 'moco' else \
        torch.from_numpy(data['flow']).to(device)
    track = {}
    t0 = time.time()
    for s in range(steps):
        ts = time.perf_counter()
        vids, offs, angs = sample_batch_idx(rng, data, train_idx, args.arm,
                                            batch, T)
        log_vars = step(assemble_batch(drgb, dflow, vids, offs, angs,
                                       args.arm, T))
        loss = float(log_vars['loss'])           # the step's sync
        if on_step is not None:
            on_step(s, time.perf_counter() - ts, loss)
        if s % 25 == 0 or s == steps - 1:
            snap = {k: round(float(v), 4) for k, v in log_vars.items()
                    if k.startswith('loss')}
            track[s] = snap
            print(f'[{args.arm}] step {s} ({time.time() - t0:.0f}s): '
                  f'{snap}', flush=True)

    train_s = time.time() - t0
    print(f'[{args.arm}] {steps} steps in {train_s:.3f}s '
          f'({1e3 * train_s / steps:.2f} ms a step)', flush=True)
    final_metrics = downstream(model, data, T, args.arm, train_idx,
                               test_idx, device)
    print(f'[{args.arm}] pretrained: {final_metrics}', flush=True)

    os.makedirs(args.out_dir, exist_ok=True)
    out = os.path.join(args.out_dir,
                       f'{args.arm}_{args.scale}_s{args.seed}.json')
    record = dict(arm=args.arm, scale=args.scale, seed=args.seed,
                  steps=steps, batch=batch, K=K, hw=hw, T=T, n_videos=n,
                  platform=device.type, init=init_metrics,
                  final=final_metrics, losses=track)
    with open(out, 'w') as f:
        json.dump(record, f, indent=1)
    print(f'wrote {out}', flush=True)
    return record


if __name__ == '__main__':
    main()
