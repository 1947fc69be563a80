"""Chip check of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout. Phases, in order; any failure raises and
the exit code is nonzero:

1. build every kernel under mscl_torch/csrc with nvcc (sm_90a), in parallel;
2. hold each kernel against its plain PyTorch version at the flagship
   shapes (B=32, C=128, K=65536, float32) and time it, its plain version
   and the one PyTorch call that computes the same product;
3. hold the port on the card against the port on the CPU (kernels and
   cuDNN against the plain versions) for two train steps of a narrow
   MSCLWithAug;
4. drive the flagship MSCLWithAug r18 pretrain step (full width, K=65536,
   IdentityAug, float32, batch 32) through build_model_from_cfg,
   build_optimizer and make_train_step for 3 steps, with the kernel launch
   counters set to 0 just before and read just after;
5. print the kernel table, the card's name and power limit, and the result.

It needs a CUDA device: without one it exits nonzero before printing any
result.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

from mscl_torch.apis import (MOCO_FREEZE, build_model_from_cfg,
                             flagship_batch, load_flagship_config,
                             narrow_flagship_cfg, to_torch)
from mscl_torch.core import build_lr_schedule, build_optimizer, \
    make_train_step
from mscl_torch.models.recognizers import build_ema_fn
from mscl_torch.ops import cuda_build
from mscl_torch.ops import decayed_infonce as di

B, C, K = 32, 128, 65536
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
FP32_FLOP_PER_S = 67e12            # H100 SXM float32 outside tensor cores
FWD_TOL = dict(rtol=1e-5, atol=1e-5)   # tests/test_ops.py forward
DQ_TOL = dict(rtol=1e-4, atol=1e-4)    # tests/test_ops.py gradient
# each kernel against float64, relative to its output's largest entry: f32
# rounding at the flagship shapes is about 1e-6 of it, one dropped K-tile
# of the 65536 about 1e-2
F64_REL = 1e-5
# card vs CPU on the narrow model: cuDNN and the kernels sum in other orders
# than the CPU, and the 1/T = 14.3 logit scale amplifies f32 rounding
STEP_TOL = dict(rtol=1e-3, atol=1e-3)
LOSS_KEYS = ['loss_cls', 'loss_cls_flow', 'loss_cls_flow_aug', 'loss_cls_mx',
             'loss_cls_mx_r', 'loss_cls_mx_aug', 'loss_cls_mx_r_aug',
             'loss_pos']
STEPS = 3


def log(**kw):
    print(json.dumps(kw), flush=True)


def time_ms(fn, iters=20, flush=None):
    """Mean device time of fn over iters launches (CUDA events around each
    launch), after a warm-up; with flush, L2 is overwritten before each."""
    for _ in range(3):
        fn()
    total = 0.0
    for _ in range(iters):
        if flush is not None:
            flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def bound(bytes_moved, flops):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def phase_kernels(dev):
    """Each kernel against its plain version at the flagship shapes."""
    rng = np.random.default_rng(0)
    q = rng.normal(size=(B, C)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    queue = rng.normal(size=(C, K)).astype(np.float32)
    queue /= np.linalg.norm(queue, axis=0, keepdims=True)
    count = rng.integers(0, 65536, size=K)
    g = rng.normal(size=(B, K)).astype(np.float32)
    q, queue, g = (torch.from_numpy(x).to(dev) for x in (q, queue, g))
    decay = di.decay_weights(torch.from_numpy(count).to(dev), 0.99999)

    qg = q.clone().requires_grad_(True)
    out = di.decayed_neg(qg, queue, decay)
    out.backward(g)
    want = di.l_neg_plain(q, queue, decay)
    want_dq = di.dq_plain(g, queue, decay)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.detach(), want, **FWD_TOL)
    torch.testing.assert_close(qg.grad, want_dq, **DQ_TOL)
    # both against float64, so an exact agreement with the plain version
    # (cuBLAS may sum in the kernel's order) is not the only evidence
    w64 = queue.double() * decay.double()
    err64 = {}
    for name, got, ref in (('l_neg', out.detach(), q.double() @ w64),
                           ('dq', qg.grad, g.double() @ w64.T)):
        err = (got.double() - ref).abs().max().item()
        limit = F64_REL * ref.abs().max().item()
        err64[name], err64[name + '_limit'] = err, limit
        if not err <= limit:
            raise AssertionError(f'{name}: {err} from float64 > {limit}')
    log(phase='kernel_vs_float64', **err64)
    # K=1000 is not a multiple of the 128-column K-tile
    ragged = queue[:, :1000].contiguous(), decay[:1000].contiguous()
    for fn, lhs in ((di.l_neg, q), (di.dq, g[:, :1000].contiguous())):
        try:
            fn(lhs, *ragged)
        except ValueError as e:
            if 'K-tile' not in str(e):
                raise
        else:
            raise AssertionError(f'{fn.__name__} took a ragged K')

    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)
    w = queue * decay
    f4 = 4
    rows = []
    for name, kernel, plain, library, err, nbytes in (
            ('decayed_infonce_l_neg', lambda: di.l_neg(q, queue, decay),
             lambda: di.l_neg_plain(q, queue, decay),
             lambda: torch.matmul(q, w),
             (out.detach() - want).abs().max().item(),
             f4 * (B * C + C * K + K + B * K)),
            ('decayed_infonce_dq', lambda: di.dq(g, queue, decay),
             lambda: di.dq_plain(g, queue, decay),
             lambda: torch.matmul(g, w.T),
             (qg.grad - want_dq).abs().max().item(),
             f4 * (B * K + C * K + K + B * C))):
        bound_ms, bound_by = bound(nbytes, 2 * B * C * K + C * K)
        row = dict(name=name, max_abs_err=err,
                   kernel_ms=time_ms(kernel, flush=flush),
                   plain_ms=time_ms(plain, flush=flush),
                   library_ms=time_ms(library, flush=flush),
                   bound_ms=bound_ms, bound_by=bound_by,
                   launches_per_step=7)
        log(phase='kernel', **row)
        rows.append(row)
    return rows


def phase_card_vs_cpu():
    """Two train steps of a narrow model on the card and on the CPU, from
    the same weights and batches."""
    cfg = narrow_flagship_cfg()
    logs = {}
    for dev in ('cpu', 'cuda'):
        model = build_model_from_cfg(cfg, device=dev, seed=1)
        opt = build_optimizer(
            model, dict(type='SGD', lr=0.02, momentum=0.9,
                        weight_decay=1e-4),
            build_lr_schedule(dict(policy='CosineAnnealing', min_lr=0), 0.02,
                              400, 100),
            grad_clip=dict(max_norm=40), freeze_patterns=MOCO_FREEZE)
        step = make_train_step(model, opt, build_ema_fn(model))
        logs[dev] = [{k: v.item() for k, v in step(to_torch(
            flagship_batch(4, hw=32, seed=s), dev)).items()} for s in (1, 2)]
        logs[dev + '_queue'] = model.recognizer_flow.queue.cpu()
    worst = 0.0
    for cpu, card in zip(logs['cpu'], logs['cuda']):
        for k in LOSS_KEYS + ['loss']:
            torch.testing.assert_close(torch.tensor(card[k]),
                                       torch.tensor(cpu[k]), **STEP_TOL)
            worst = max(worst, abs(card[k] - cpu[k]))
    torch.testing.assert_close(logs['cuda_queue'], logs['cpu_queue'],
                               **STEP_TOL)
    log(phase='card_vs_cpu', steps=2, max_abs_loss_diff=worst,
        **{f'loss_step{i + 1}': v['loss'] for i, v in
           enumerate(logs['cuda'])})


def phase_flagship(dev):
    cfg = load_flagship_config()
    model = build_model_from_cfg(cfg.model.to_dict(), device=dev, seed=0)
    bs = cfg.data['videos_per_gpu']
    lr = build_lr_schedule(cfg.lr_config.to_dict(), cfg.optimizer['lr'],
                           cfg.total_epochs, cfg.dataset_size // bs)
    opt = build_optimizer(model, cfg.optimizer.to_dict(), lr,
                          grad_clip=cfg.optimizer_config['grad_clip'],
                          freeze_patterns=MOCO_FREEZE)
    step = make_train_step(model, opt, build_ema_fn(model))
    batch = to_torch(flagship_batch(bs, seed=0), dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    di.l_neg.launches = 0
    di.dq.launches = 0
    step_ms, losses = [], []
    for _ in range(STEPS):
        t0 = time.perf_counter()
        log_vars = step(batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append({k: v.item() for k, v in log_vars.items()})
    launches = dict(l_neg=di.l_neg.launches, dq=di.dq.launches)

    for i, lv in enumerate(losses):
        missing = [k for k in LOSS_KEYS if k not in lv]
        bad = [k for k in LOSS_KEYS + ['loss'] if not math.isfinite(lv[k])]
        if missing or bad:
            raise AssertionError(f'step {i + 1}: missing {missing}, '
                                 f'non-finite {bad}')
    state = {f'{t}.{n}': int(getattr(getattr(model, t), n))
             for t in ('recognizer', 'recognizer_flow')
             for n in ('queue_ptr', 'iters')}
    want = {'recognizer.queue_ptr': STEPS * bs,
            'recognizer_flow.queue_ptr': STEPS * bs,
            'recognizer.iters': STEPS * bs,
            'recognizer_flow.iters': 2 * STEPS * bs}
    if state != want:
        raise AssertionError(f'moco state {state} != {want}')
    if launches != dict(l_neg=7 * STEPS, dq=7 * STEPS):
        raise AssertionError(f'kernel launches {launches} != {7 * STEPS} '
                             'each')
    peak = torch.cuda.max_memory_allocated()

    # cost of the key-side TPN neck, whose outputs nothing reads
    rgb = model.recognizer
    with torch.no_grad():
        feats = rgb.encoder_k(batch['imgs'][1])
        neck_k_ms = time_ms(lambda: rgb.neck_k(feats), iters=10)
    log(phase='flagship_step', steps=STEPS, batch=bs, K=rgb.K,
        step_ms=step_ms, peak_bytes=peak, launches=launches, state=state,
        neck_k_ms=neck_k_ms,
        losses=[{k: lv[k] for k in LOSS_KEYS + ['loss']} for lv in losses])
    profile_step(step, batch)
    return launches


def _kernel_class(name):
    """Class of a device kernel by its name; the first match wins, so BN
    and resize kernels that cuDNN or a conv-like name carries come first."""
    n = name.lower()
    for cls, keys in (('decayed_infonce', ('l_neg_kernel', 'dq_partial',
                                           'dq_reduce')),
                      ('batch_norm', ('bn_fw', 'bn_bw', 'batch_norm',
                                      'batchnorm')),
                      ('upsample', ('upsample',)),
                      ('conv', ('conv', 'xmma', 'implicit', 'wgrad', 'dgrad',
                                'fprop', 'cudnn')),
                      ('gemm', ('gemm', 'gemv', 'cutlass')),
                      ('reduce', ('reduce',))):
        if any(k in n for k in keys):
            return cls
    return 'elementwise_other'


def profile_step(step, batch):
    """Device time by kernel class over one more flagship step, and the
    device's busy share of that step's wall time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_class, top = {}, []
    for e in prof.key_averages():
        if getattr(e, 'device_type', None) != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, 'self_device_time_total', None)
        if us is None:
            us = getattr(e, 'self_cuda_time_total', 0.0)
        cls = _kernel_class(e.key)
        by_class[cls] = by_class.get(cls, 0.0) + us / 1e3
        top.append((us / 1e3, e.count, e.key[:90]))
    busy = sum(by_class.values())
    top.sort(reverse=True)
    log(phase='profile', wall_ms=wall_ms, device_busy_ms=busy,
        device_idle_share=(1 - busy / wall_ms) if busy else None,
        by_class_ms=dict(sorted(by_class.items(), key=lambda kv: -kv[1])),
        top_kernels=[dict(ms=ms, count=n, name=k) for ms, n, k in top[:12]])


def main():
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 1
    dev = torch.device('cuda')
    t0 = time.perf_counter()
    cuda_build.build(cuda_build.all_sources())
    log(phase='build', sources=cuda_build.all_sources(),
        seconds=time.perf_counter() - t0)

    rows = phase_kernels(dev)
    phase_card_vs_cpu()
    launches = phase_flagship(dev)

    # the TPU functions that reach pl.pallas_call: _pallas_l_neg, _pallas_dq
    replaces = {'decayed_infonce_l_neg': 'mscl_tpu/ops/decayed_infonce.py:62',
                'decayed_infonce_dq': 'mscl_tpu/ops/decayed_infonce.py:86'}
    counts = {'decayed_infonce_l_neg': launches['l_neg'],
              'decayed_infonce_dq': launches['dq']}
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    print(json.dumps({'kernels': [dict(
        name=r['name'], route='cuda',
        source='mscl_torch/csrc/decayed_infonce.cu',
        replaces=replaces[r['name']], launches=counts[r['name']],
        max_abs_err=r['max_abs_err'], ms=r['kernel_ms'],
        plain_ms=r['plain_ms'],
        bound_ms=r['bound_ms'], bound_by=r['bound_by'],
        library_ms=r['library_ms']) for r in rows]}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
