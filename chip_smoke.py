"""Chip check of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout. Phases, in order; any failure raises and
the exit code is nonzero:

1. build every kernel under mscl_torch/csrc with nvcc (sm_90a), in parallel;
2. hold the decayed-InfoNCE kernels against their plain PyTorch versions and
   float64 at the flagship shapes (B=32, C=128, K=65536, float32) and time
   them in turns with the one PyTorch call that computes the same product
   (kernel, library, library, kernel), then their plain versions, and one
   plain read of the queue as the floor of their bytes; log each kernel's
   device time in one profiled call, their ptxas report and launch shape;
3. hold the correlation-lookup kernel against its plain version and float64
   at the flow-extraction shape (N=8, 16x22: 128x171 frames padded to
   128x176, at 1/8) and at RAFT's 440x1024 (N=1, 55x128), C=256, L=4, r=4,
   with coords the grid plus normal noise of scale 8, a smooth flow, and (at
   440x1024) noise of scale 64, whose window unions exceed a stage; two
   calls must give the same bits; coords at -1000 must give exact zeros;
   time the kernel (and its host time a call, and level 0 alone) and its
   plain version with L2 flushed; log the corners, the bytes a per-corner
   gather would move and the bytes the kernel's tiles stage; its ptxas
   report and launch (no spill) and a SASS check for its staging copies
   (corr_lookup_ptxas);
4. the tensor-core fill probes (mxu_fill): each kernel against its plain
   version and float64 at the first case of each of the tool's case lists
   (M=3248; carry also at mt=1624), then timed at 132 steps with L2 flushed
   beside its plain version (and, for bigdot, one batched torch.matmul),
   each under the card's 989 TF/s; each probe's persistent kernel also at
   66 steps (its fastest launch at 132 must take 1.7-2.3x as long), with
   its plan (tile, ring, slabs, sub-tiles, blocks, groups), the L2 bytes
   it implies and the host's time for a call; every kernel's SASS checked
   for wgmma and TMA and no mma.sync (probe's and paircat's also for
   shared loads and stores, their accumulator), and ptxas's report for no
   spill (and where it serialized wgmma); then the tool's three case lists
   through its main() at its own steps, and cuDNN's r3d_18 layer1
   convolution as the yardstick;
5. the device augmentation (the flagship config's SyncMoCoAugmentV5) at the
   flagship batch (32 clips of 3x8x112x112, flows 2x16x112x112): on the
   card against the CPU with the same draws, float32; the card generator's
   rates at B=4096; its device time alone (draws and apply) in float32 and
   bfloat16; and one call under torch.cuda.set_sync_debug_mode('error'),
   which fails on any host synchronisation;
6. hold the port on the card against the port on the CPU (kernels and
   cuDNN against the plain versions): two train steps of a narrow
   MSCLWithAug with IdentityAug and with V5 (both fed the same draws), and
   RAFT (full width, 64x64 images, 3 iterations);
7. drive the flagship config's own MSCLWithAug r18 pretrain step (full
   width, K=65536, SyncMoCoAugmentV5, batch 32) through
   build_model_from_cfg, build_optimizer and make_train_step, in float32
   and then in bfloat16: 3 steps each, then profile one;
8. drive flow extraction through make_raft_fn(None, iters=12) (RAFT large
   at full width, random weights from a seed): 3 batches of 8 synthetic
   frame pairs at 128x171, then profile one;
9. print the kernel table, the card's name and power limit, and the result.

Every kernel launch counter is set to 0 just before each of the paths 7
(each dtype) and 8 and the probe tool's run in 4, and read just after.
The kernel table's decayed-InfoNCE launches are the float32 step's. It
needs a CUDA device: without one it exits nonzero before printing any
result.
"""
from __future__ import annotations

import json
import math
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from mscl_torch.apis import (FLAGSHIP_AUG, MOCO_FREEZE, build_model_from_cfg,
                             flagship_batch, load_flagship_config,
                             narrow_flagship_cfg, to_torch)
from mscl_torch.apis.flow_extraction import make_raft_fn
from mscl_torch.core import build_lr_schedule, build_optimizer, \
    make_train_step
from mscl_torch.flow import build_raft
from mscl_torch.models import build_ssl_aug
from mscl_torch.models.recognizers import build_ema_fn
from mscl_torch.ops import corr_lookup as cl
from mscl_torch.ops import cuda_build
from mscl_torch.ops import decayed_infonce as di
from mscl_torch.ops import mxu_fill as mf
from mscl_torch.tools import bench_mxu_fill as bm

B, C, K = 32, 128, 65536
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
FP32_FLOP_PER_S = 67e12            # H100 SXM float32 outside tensor cores
BF16_FLOP_PER_S = 989e12           # H100 SXM dense bf16 tensor cores
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
# correlation lookup: (shape name, N, H, W) at C=256, 4 levels, radius 4
CORR_SHAPES = (('extraction_16x22', 8, 16, 22), ('raft_55x128', 1, 55, 128))
CORR_C, CORR_LEVELS, CORR_RADIUS = 256, 4, 4
CORR_TOL = dict(rtol=1e-5, atol=1e-5)  # tests/test_ops.py atol; C=256 sums
# wide flow at RAFT's 440x1024: window unions beyond one stage
CORR_WIDE_SHAPE, CORR_WIDE_SCALE = 'raft_55x128', 64.0
# RAFT card vs CPU: the CPU's float32 flows differ from float64 ones by
# about 7e-6 at a largest flow of 10 (64x64, 3 iterations); cuDNN sums in
# other orders (and may take Winograd), so 100 times that
RAFT_TOL = dict(rtol=1e-3, atol=1e-3)
EXTRACT_PAIRS, EXTRACT_HW, EXTRACT_BATCHES, RAFT_ITERS = 8, (128, 171), 3, 12
# fill probes at 132 steps: each kernel walks its (step, tile) units on
# persistent blocks (probe, bigdot, imcat 1,716 of 256 rows, carry at
# mt=112 3,828 of 128); the tool's first case of each probe
MXU_STEPS = 132
MXU_TOL = dict(rtol=1e-2, atol=1e-2)   # one bf16 rounding, sums reordered
MXU_F64_REL = 8e-3                     # one bf16 rounding (2^-7) of the max
MXU_CLI_ITERS = 3                      # the tool's default
MXU_ROWS = (('mxu_fill_probe', '', 0), ('mxu_fill_carry', 'carry', 0),
            ('mxu_fill_bigdot', 'kchain', 2), ('mxu_fill_imcat', 'kchain', 4),
            ('mxu_fill_paircat', 'kchain', 6))
MXU_REPLACES = {'probe': 34, 'carry': 72, 'bigdot': 117, 'imcat': 151,
                'paircat': 195}
# the probes' persistent kernels: each step's units must really run, so
# twice the steps take about twice the time
STEPS_RATIO = (1.7, 2.3)
# r3d_18 layer1: (32, 64, 8, 56, 56) -> 64, 3x3x3, padding 1
CONV_SHAPE, CONV_FLOP = (32, 64, 8, 56, 56), 2 * 32 * 8 * 56 * 56 * 64 * 1728
SPIN_CYCLES = 200_000              # about 0.1 ms of the card's clock
# the device aug against the CPU (tests/test_torch_ssl_aug.py): float32
# colour math within 1e-5; the colour wheel's floor(255 col) may flip by
# 1/255 on a share of at most 1e-5 of the elements
AUG_TOL, WHEEL_STEP, WHEEL_SHARE = 1e-5, 1 / 255 + 1e-6, 1e-5
RATE_B = 4096                      # draws for the apply-rate check
AUG_RATES = dict(flip=0.5, jitter=0.8, gray=0.2, blur=0.5)


def log(**kw):
    print(json.dumps(kw), flush=True)


def launch_ms(fn, iters=20, flush=None, warmup=3):
    """Device time of each of iters launches of fn (CUDA events around each
    launch), after a warm-up; with flush, L2 is overwritten before each.
    The device spins for about 0.1 ms before the start event, so the host
    has enqueued fn before the event is reached: the host's own time for
    the call (tens of microseconds in Python) stays out of the window."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        if flush is not None:
            flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def time_ms(fn, iters=20, flush=None, warmup=3):
    """Mean device time of fn over iters launches (launch_ms)."""
    return sum(launch_ms(fn, iters, flush, warmup)) / iters


def host_us(fn, iters=20):
    """Mean host time of a call of fn that only enqueues device work, in
    microseconds: what time_ms's spin must cover."""
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(iters):
        fn()
    us = (time.perf_counter() - start) / iters * 1e6
    torch.cuda.synchronize()
    return us


def bound(bytes_moved, flops, flop_per_s=FP32_FLOP_PER_S):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flop_per_s * 1e3
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
        # kernel and library in turns on this card: kernel, library,
        # library, kernel, after one untimed round of each (the first
        # timed turn ran slow without it); each the mean of its two turns
        for fn in (kernel, library):
            time_ms(fn, iters=5, flush=flush)
        turns = [time_ms(fn, flush=flush)
                 for fn in (kernel, library, library, kernel)]
        row = dict(name=name, max_abs_err=err,
                   kernel_ms=(turns[0] + turns[3]) / 2,
                   library_ms=(turns[1] + turns[2]) / 2,
                   turns_ms=turns, plain_ms=time_ms(plain, flush=flush),
                   bound_ms=bound_ms, bound_by=bound_by,
                   launches_per_step=7)
        row['bound_share'] = bound_ms / row['kernel_ms']
        row['device_ms_by_kernel'] = device_ms_by_kernel(kernel, flush)
        log(phase='kernel', **row)
        rows.append(row)
    # what one plain read of the queue takes under the same flush: the
    # practical floor of both kernels' bytes on this card
    log(phase='queue_read', bytes=f4 * C * K,
        ms=time_ms(lambda: queue.sum(), flush=flush))
    log(phase='decayed_infonce_ptxas', launch=di.launch_info(C), kernels=[
        dict(v, kernel=ptxas_short(k)) for k, v in
        cuda_build.ptxas_report('decayed_infonce').items()])
    return rows


def device_ms_by_kernel(fn, flush):
    """Device time of each kernel that one call of fn runs, L2 flushed."""
    from torch.profiler import ProfilerActivity
    flush.zero_()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {ptxas_short(e.key): device_us(e) / 1e3 for e in prof.key_averages()
            if getattr(e, 'device_type', None) ==
            torch.autograd.DeviceType.CUDA}


def device_us(event):
    us = getattr(event, 'self_device_time_total', None)
    return getattr(event, 'self_cuda_time_total', 0.0) if us is None else us


def reset_launch_counts():
    di.l_neg.launches = di.dq.launches = cl.corr_lookup.launches = 0
    for fn in mf.ENTRY_POINTS.values():
        fn.launches = 0


def corr_inputs(dev, n, h, w, seed):
    rng = np.random.default_rng(seed)
    f1, f2 = (rng.normal(size=(n, h, w, CORR_C)).astype(np.float32)
              for _ in range(2))
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing='ij')
    coords = np.stack([xs, ys], -1)[None].repeat(n, 0) + rng.normal(
        scale=8.0, size=(n, h, w, 2))
    return (torch.from_numpy(x).to(dev) for x in
            (f1, f2, coords.astype(np.float32)))


def smooth_coords(dev, n, h, w):
    """The grid plus a smooth flow of amplitude 8, as a real flow field is
    (neighbouring windows overlap, unlike under per-pixel noise)."""
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing='ij')
    flow = 8 * np.stack([np.sin(ys / 5.0), np.cos(xs / 7.0)], -1)
    coords = (np.stack([xs, ys], -1) + flow)[None].repeat(n, 0)
    return torch.from_numpy(coords.astype(np.float32)).to(dev)


def corr_corners(coords, h, w):
    """In-range integer corners that the lookup at these coords reads, over
    all levels: 2*C operations each."""
    kc, total = 2 * CORR_RADIUS + 2, 0
    for l in range(CORR_LEVELS):
        start = torch.floor(coords / 2 ** l).clamp(-65536, 65536) - \
            CORR_RADIUS
        span = []
        for i, size in ((0, w >> l), (1, h >> l)):
            lo = start[..., i].clamp(min=0)
            hi = (start[..., i] + kc).clamp(max=size)
            span.append((hi - lo).clamp(min=0))
        total += int((span[0] * span[1]).sum().item())
    return total


def wide_coords(dev, n, h, w, seed):
    """The grid plus normal noise of scale CORR_WIDE_SCALE: each tile's
    window union spreads over most of a level, beyond one stage."""
    rng = np.random.default_rng(seed)
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing='ij')
    coords = np.stack([xs, ys], -1)[None].repeat(n, 0) + rng.normal(
        scale=CORR_WIDE_SCALE, size=(n, h, w, 2))
    return torch.from_numpy(coords.astype(np.float32)).to(dev)


def corr_check(name, f1, pyr, coords):
    """The lookup kernel at these coords against its plain version and
    float64; two calls must give the same bits. Returns its errors."""
    out = cl.corr_lookup(f1, pyr, coords, CORR_LEVELS, CORR_RADIUS)
    again = cl.corr_lookup(f1, pyr, coords, CORR_LEVELS, CORR_RADIUS)
    want = cl.corr_lookup_plain(f1, pyr.levels, coords, CORR_RADIUS)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, want, **CORR_TOL)
    if not torch.equal(out, again):
        raise AssertionError(f'corr_lookup {name}: two calls differ')
    ref = cl.corr_lookup_plain(f1.double(), [v.double() for v in pyr.levels],
                               coords.double(), CORR_RADIUS)
    err64 = (out.double() - ref).abs().max().item()
    limit = F64_REL * ref.abs().max().item()
    if not err64 <= limit:
        raise AssertionError(f'corr_lookup {name}: {err64} from float64 > '
                             f'{limit}')
    return dict(max_abs_err=(out - want).abs().max().item(), f64_err=err64,
                f64_limit=limit), out


def corr_traffic(coords, h, w):
    """What the lookup at these coords reads on chip: its in-range corners,
    the bytes a per-corner gather of f2 rows would move, and the bytes the
    kernel's tiles stage from L2 (and their union boxes would), counted on
    the host from its tile plan."""
    corners = corr_corners(coords, h, w)
    staged, boxed = cl.staged_positions(coords, CORR_LEVELS, CORR_RADIUS)
    row = 4 * CORR_C
    return dict(corners=corners, gather_bytes=corners * row,
                staged_bytes=staged * row, box_bytes=boxed * row)


def phase_corr_lookup(dev):
    """The lookup kernel against its plain version and float64, at the
    extraction shape and at RAFT's 440x1024, with noisy, smooth and (at
    440x1024) wide flows, and far off the image; timed with L2 flushed."""
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)
    rows = {}
    for i, (name, n, h, w) in enumerate(CORR_SHAPES):
        f1, f2, coords = corr_inputs(dev, n, h, w, seed=10 + i)
        pyr = cl.corr_pyramid(f2, CORR_LEVELS)
        flows = dict(noise=coords, smooth=smooth_coords(dev, n, h, w))
        if name == CORR_WIDE_SHAPE:
            flows['wide'] = wide_coords(dev, n, h, w, seed=20 + i)
        # level 0 alone: what the coarser levels add to a call
        pyr0 = cl.corr_pyramid(f2, 1)
        checks = {}
        for flow, cds in flows.items():
            errs, out = corr_check(f'{name} {flow}', f1, pyr, cds)

            def call(cds=cds):
                return cl.corr_lookup(f1, pyr, cds, CORR_LEVELS, CORR_RADIUS)
            checks[flow] = dict(
                errs, **corr_traffic(cds, h, w),
                kernel_ms=time_ms(call, flush=flush),
                level0_ms=time_ms(lambda cds=cds: cl.corr_lookup(
                    f1, pyr0, cds, 1, CORR_RADIUS), flush=flush),
                host_us=host_us(call))
            log(phase='corr_lookup_flow', shape=name, flow=flow,
                **checks[flow])
        far = cl.corr_lookup(f1, pyr, torch.full_like(coords, -1000.0),
                             CORR_LEVELS, CORR_RADIUS)
        if far.any():
            raise AssertionError(f'corr_lookup {name}: nonzero far off the '
                                 'image')
        noise = checks['noise']
        nbytes = 4 * (f1.numel() + pyr.flat.numel() + coords.numel() +
                      out.numel())
        bound_ms, bound_by = bound(nbytes, 2 * CORR_C * noise['corners'])
        row = dict(
            shape=name, n=n, h=h, w=w, max_abs_err=max(
                c['max_abs_err'] for c in checks.values()),
            f64_err=noise['f64_err'], f64_limit=noise['f64_limit'],
            corners=noise['corners'],
            corners_max=n * h * w * CORR_LEVELS * (2 * CORR_RADIUS + 2) ** 2,
            bytes=nbytes, kernel_ms=noise['kernel_ms'],
            kernel_ms_smooth=checks['smooth']['kernel_ms'],
            corners_smooth=checks['smooth']['corners'],
            plain_ms=time_ms(lambda: cl.corr_lookup_plain(
                f1, pyr.levels, coords, CORR_RADIUS), iters=5, flush=flush),
            bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
            plan=cl.plan(n, h, w, CORR_C, CORR_RADIUS))
        log(phase='corr_lookup_kernel', **row)
        rows[name] = row
    corr_ptxas()
    return rows


def corr_ptxas():
    """The lookup kernel's registers, spills and shared memory (ptxas) and
    its launch (the library's own report, which must agree with the host's
    plan); no spill, and its staging copies in the SASS (LDGSTS, or UTMALDG
    for a TMA design)."""
    info = cl.launch_info(CORR_C, CORR_RADIUS)
    plan = cl.plan(1, 16, 16, CORR_C, CORR_RADIUS)
    report = [dict(v, kernel=ptxas_short(k)) for k, v in
              cuda_build.ptxas_report('corr_lookup').items()]
    tool = shutil.which('cuobjdump') or '/usr/local/cuda/bin/cuobjdump'
    sass = subprocess.run([tool, '-sass', str(cuda_build.library_path(
        'corr_lookup'))], capture_output=True, text=True, check=True).stdout
    ops = {op: len(re.findall(op + r'\b', sass))
           for op in ('LDGSTS', 'UTMALDG', 'LDS', 'FFMA')}
    log(phase='corr_lookup_ptxas', launch=info, kernels=report, sass=ops)
    spilled = [r['kernel'] for r in report if r.get('spill_store_bytes', 1)
               or r.get('spill_load_bytes', 1)]
    if spilled or not report:
        raise AssertionError(f'corr_lookup kernels spill: {spilled}')
    if not ops['LDGSTS'] + ops['UTMALDG']:
        raise AssertionError(f'corr_lookup SASS stages nothing: {ops}')
    mismatch = {k: (info[k], plan[k]) for k in plan if k in info and
                info[k] != plan[k]}
    if mismatch or info['blocks_per_sm'] < 1:
        raise AssertionError(f'corr_lookup launch {info} against plan '
                             f'{plan}: {mismatch}')


def mxu_check(dev, case):
    """A probe's kernel at MXU_STEPS steps against its plain version, and
    both against float64, at the tool's M and inputs."""
    x, w = bm.inputs(case, dev)
    shape = dict(m=bm.M, **case.shape)
    got = bm.call(case, x, w, steps=MXU_STEPS)
    want = mf.PLAIN_VERSIONS[case.kind](x, w, **shape)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), **MXU_TOL)
    ref = mf.reference(case.kind, x, w, **shape)
    limit = MXU_F64_REL * ref.abs().max().item()
    errs = {}
    for label, out in (('f64_err', got), ('plain_f64_err', want)):
        errs[label] = (out.double() - ref).abs().max().item()
        if not errs[label] <= limit:
            raise AssertionError(f'{case.name}: {label} {errs[label]} > '
                                 f'{limit}')
    return x, w, dict(errs, f64_limit=limit, max_abs_err=(
        got.float() - want.float()).abs().max().item())


def bigdot_library(x, w, flush):
    """One torch.matmul computing the MXU_STEPS products of a bigdot launch
    on a stride-0 batch of x and w, timed, and the device kernels it runs."""
    from torch.profiler import ProfilerActivity
    xb, wb = x.expand(MXU_STEPS, *x.shape), w.expand(MXU_STEPS, *w.shape)
    ms = time_ms(lambda: torch.matmul(xb, wb), flush=flush)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.matmul(xb, wb)
        torch.cuda.synchronize()
    kernels = sorted({e.key[:90] for e in prof.key_averages() if getattr(
        e, 'device_type', None) == torch.autograd.DeviceType.CUDA})
    return ms, kernels


def ptxas_short(kernel):
    """A kernel's mangled name as name<template arguments>."""
    m = re.search(r'([a-z][a-z_]*_kernel)((?:IL[ib]\d+E(?:L[ib]\d+E)*E)?)',
                  kernel)
    if not m:
        return kernel
    args = re.findall(r'L[ib](\d+)E', m[2])
    return f'{m[1]}<{", ".join(args)}>' if args else m[1]


def l2_bytes(case, plan):
    """Bytes a probe's kernel reads from L2 in a launch, by its design: each
    unit reads its rows of x (bigdot: its tile's rows; the others their
    (BM+8)-row slab) and all of w once."""
    s, units = case.shape, plan['units']
    depth = s['k'] * s.get('inner', 1)
    x_rows = (bm.M * MXU_STEPS if case.kind == 'bigdot' else
              units * (plan['bm'] + 8))
    return 2 * (x_rows * s['k'] + units * depth * s['n'])


def kernel_name(case, plan):
    """The instantiation a case's plan launches, as ptxas_short names it."""
    n, rows = case.shape['n'], plan['bm']
    if case.kind in ('bigdot', 'imcat'):
        return f"kcat_gemm_kernel<{n}, {rows}, {int(case.kind == 'imcat')}>"
    return f"tap_wgmma_kernel<{n}, {rows}, {int(case.kind != 'carry')}>"


def mxu_schedule(case, x, w, flush):
    """A probe's persistent schedule: its plan, the L2 bytes it implies,
    the time at half the steps (each step's work must run), and the host's
    time for a call. The steps are compared by their fastest launches, which
    a stall of the host (the card shares it) cannot lengthen."""
    plan = mf.plan(case.kind, bm.M, steps=MXU_STEPS, **case.shape)
    ms = {st: min(launch_ms(lambda: bm.call(case, x, w, steps=st),
                            flush=flush))
          for st in (MXU_STEPS // 2, MXU_STEPS)}
    ratio = ms[MXU_STEPS] / ms[MXU_STEPS // 2]
    l2 = l2_bytes(case, plan)
    log(phase='mxu_schedule', case=case.name.strip(),
        kernel=kernel_name(case, plan), **plan, ms_by_steps=ms,
        steps_ratio=ratio, l2_bytes=l2, l2_tb_per_s=l2 / ms[MXU_STEPS] / 1e9,
        host_us=host_us(lambda: bm.call(case, x, w, steps=MXU_STEPS)))
    lo, hi = STEPS_RATIO
    if not lo <= ratio <= hi:
        raise AssertionError(f'{case.name}: {MXU_STEPS} steps take {ratio:.2f}'
                             f'x the time of {MXU_STEPS // 2}')


def mxu_sass():
    """The SASS of the built fill-probe kernels: each must issue wgmma
    (HGMMA) and TMA loads (UTMALDG), and none mma.sync (HMMA); the tap
    kernels with their accumulator in shared memory (probe, paircat) must
    also load and store it there (LDS, STS)."""
    tool = shutil.which('cuobjdump') or '/usr/local/cuda/bin/cuobjdump'
    sass = subprocess.run([tool, '-sass', str(cuda_build.library_path(
        'mxu_fill'))], capture_output=True, text=True, check=True).stdout
    counts = {}
    for sec in re.split(r'\n\s*Function : ', sass)[1:]:
        name = ptxas_short(sec.split('\n', 1)[0].strip())
        counts[name] = {op: len(re.findall(op + r'\b', sec))
                        for op in ('HGMMA', 'UTMALDG', 'HMMA', 'LDS', 'STS')}
    log(phase='mxu_sass', kernels=counts)
    # kcat: bigdot at 256 rows, imcat at 128 and 256; tap: the shared
    # accumulator at 256 rows (N=64) and 128 (N=128), carry at 128 and 256;
    # each at N = 64 and 128
    bad = [k for k, c in counts.items()
           if c['HGMMA'] == 0 or c['UTMALDG'] == 0 or c['HMMA'] or
           (k.startswith('tap_wgmma_kernel') and k.endswith(', 1>') and
            (c['LDS'] == 0 or c['STS'] == 0))]
    kinds = sorted(k.split('<')[0] for k in counts)
    if bad or kinds != ['kcat_gemm_kernel'] * 6 + ['tap_wgmma_kernel'] * 6:
        raise AssertionError(f'mxu_fill SASS: {counts}')


def phase_mxu_fill(dev):
    """Each fill-probe kernel against its plain version and float64 at the
    first case of its case list, then timed at MXU_STEPS steps with L2
    flushed beside its plain version (and bigdot beside torch.matmul)."""
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)
    rows = {}
    for name, mode, index in MXU_ROWS:
        case = bm.cases(mode)[index]
        x, w, errs = mxu_check(dev, case)
        flops = bm.flops_per_pass(case) * MXU_STEPS
        nbytes = 2 * (x.numel() + w.numel() + bm.M * case.shape['n'])
        bound_ms, bound_by = bound(nbytes, flops, BF16_FLOP_PER_S)
        kernel_ms = time_ms(lambda: bm.call(case, x, w, steps=MXU_STEPS),
                            flush=flush)
        plain_ms = time_ms(lambda: mf.PLAIN_VERSIONS[case.kind](
            x, w, m=bm.M, steps=MXU_STEPS, **case.shape), iters=2, warmup=1,
            flush=flush)
        library_ms, library_kernels = (bigdot_library(x, w, flush)
                                       if case.kind == 'bigdot' else
                                       (None, None))
        row = dict(name=name, case=case.name.strip(), steps=MXU_STEPS,
                   kernel_ms=kernel_ms, tflops=flops / kernel_ms / 1e9,
                   peak_share=bound_ms / kernel_ms, plain_ms=plain_ms,
                   bound_ms=bound_ms, bound_by=bound_by,
                   library_ms=library_ms, library_kernels=library_kernels,
                   **errs)
        log(phase='mxu_fill_kernel', **row)
        check_rate(row['case'], row['tflops'])
        rows[name] = row
        mxu_schedule(case, x, w, flush)
    # carry at mt=1624: 13 sub-tiles of 128 rows a tile (an accumulator of
    # all 1624 rows in registers would spill)
    case = bm.cases('carry')[4]
    x, w, errs = mxu_check(dev, case)
    kernel_ms = time_ms(lambda: bm.call(case, x, w, steps=MXU_STEPS),
                        flush=flush)
    log(phase='mxu_fill_check', case=case.name.strip(), steps=MXU_STEPS,
        kernel_ms=kernel_ms, tflops=bm.flops_per_pass(case) * MXU_STEPS /
        kernel_ms / 1e9, bound_ms=bound(0, bm.flops_per_pass(case) *
                                        MXU_STEPS, BF16_FLOP_PER_S)[0],
        **errs)
    mxu_schedule(case, x, w, flush)
    plans = {}
    for mode in ('', 'carry', 'kchain'):
        for case in bm.cases(mode):
            plan = mf.plan(case.kind, bm.M, steps=MXU_STEPS, **case.shape)
            plans.setdefault(kernel_name(case, plan), []).append(
                dict(plan, case=case.name.strip()))
    report = [dict(v, kernel=ptxas_short(k),
                   plans=plans.get(ptxas_short(k), []))
              for k, v in cuda_build.ptxas_report('mxu_fill').items()]
    log(phase='mxu_fill_ptxas', kernels=report)
    spilled = [r['kernel'] for r in report if r.get('spill_store_bytes', 1)
               or r.get('spill_load_bytes', 1)]
    if spilled or not report:
        raise AssertionError(f'mxu_fill kernels spill: {spilled}')
    mxu_sass()
    return rows


def check_rate(case, tflops):
    if not tflops < BF16_FLOP_PER_S / 1e12:
        raise AssertionError(f'{case}: {tflops} TF/s is above the card\'s '
                             'peak: some of its work did not run')


def phase_mxu_fill_tool():
    """The probe tool's three case lists through its main(), at its own
    steps and iters; returns each kernel's launches in that run."""
    reset_launch_counts()
    results = []
    for flags in ([], ['--carry'], ['--kchain']):
        results += bm.main(flags + ['--iters', str(MXU_CLI_ITERS)])
    launches = {kind: fn.launches for kind, fn in mf.ENTRY_POINTS.items()}
    want = dict.fromkeys(mf.ENTRY_POINTS, 0)
    for mode in ('', 'carry', 'kchain'):
        for case in bm.cases(mode):
            want[case.kind] += MXU_CLI_ITERS + 1
    for r in results:
        log(phase='mxu_fill_tool', **r)
        check_rate(r['name'], r['tflops'])
    if launches != want:
        raise AssertionError(f'probe launches {launches} != {want}')
    return launches


def phase_conv_yardstick(dev):
    """cuDNN's r3d_18 layer1 convolution at the flagship shape, in bf16
    channels-last-3d and in float32 with TF32 off (as the step runs it)."""
    g = torch.Generator(device=dev).manual_seed(4)
    x = torch.randn(CONV_SHAPE, device=dev, generator=g)
    wt = 0.05 * torch.randn((64, 64, 3, 3, 3), device=dev, generator=g)
    saved = torch.backends.cudnn.allow_tf32
    try:
        torch.backends.cudnn.allow_tf32 = False
        fp32_ms = time_ms(lambda: F.conv3d(x, wt, padding=1), iters=10)
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    xb, wb = (t.to(dtype=torch.bfloat16, memory_format=torch.channels_last_3d)
              for t in (x, wt))
    bf16_ms = time_ms(lambda: F.conv3d(xb, wb, padding=1), iters=10)
    log(phase='conv_yardstick', shape=list(CONV_SHAPE), out_channels=64,
        gflop=CONV_FLOP / 1e9, bf16_channels_last_ms=bf16_ms,
        bf16_tflops=CONV_FLOP / bf16_ms / 1e9, fp32_no_tf32_ms=fp32_ms,
        fp32_tflops=CONV_FLOP / fp32_ms / 1e9)


def tree_to(x, device):
    """Every tensor of a nested dict of draws, moved to device."""
    if isinstance(x, dict):
        return {k: tree_to(v, device) for k, v in x.items()}
    return x.to(device) if isinstance(x, torch.Tensor) else x


def wheel_check(name, got, want, step=WHEEL_STEP):
    """A visualised flow against another: at most a 1/255 step, on a share
    of at most WHEEL_SHARE of the elements (rounded up to one)."""
    diff = (got.float().cpu() - want.float().cpu()).abs()
    flips = int((diff > 1e-6).sum())
    if diff.max() > step or flips > max(1, int(WHEEL_SHARE * diff.numel())):
        raise AssertionError(f'{name}: largest gap {float(diff.max())}, '
                             f'{flips} of {diff.numel()} elements off')
    return float(diff.max()), flips


def aug_inputs(dev, dtype, seed=5):
    """The flagship batch's clips and flows as the step hands them to the
    aug: (im_q, im_k, aux_info) in dtype on dev."""
    batch = flagship_batch(32, seed=seed)
    im_q, im_k = (torch.from_numpy(x).to(dev, dtype) for x in batch['imgs'])
    aux = {f'flow_imgs_{s}': torch.from_numpy(x).to(dev, dtype)
           for s, x in zip('qk', batch['flow_imgs'])}
    return im_q, im_k, aux


def aug_rates(draws):
    """Share of clips each apply decision of one V5 branch took."""
    strong = draws['strong']
    return dict(flip=draws['flip'], jitter=strong['jitter']['apply'],
                gray=strong['gray']['apply'], blur=strong['blur']['apply'])


def phase_ssl_aug(dev):
    """The flagship config's aug at the flagship batch: card against CPU on
    the same draws, the card generator's rates, its device time, and no
    host synchronisation in a call."""
    aug = build_ssl_aug(load_flagship_config().model.to_dict()['aug'])
    torch.backends.cudnn.allow_tf32 = False      # as the step runs it
    gen = torch.Generator(device=dev).manual_seed(7)
    card, cpu = aug_inputs(dev, torch.float32), aug_inputs('cpu',
                                                           torch.float32)
    draws = aug.draw(gen, card[0], card[1])
    got = aug.apply(*card, draws)
    want = aug.apply(*cpu, tree_to(draws, 'cpu'))
    img_err = max(float((g.cpu() - w).abs().max())
                  for g, w in zip(got[:2], want[:2]))
    if img_err > AUG_TOL:
        raise AssertionError(f'ssl_aug clips: card vs CPU {img_err}')
    flow = {k: wheel_check(k, got[2][k], want[2][k]) for k in want[2]}
    if any(got[2][k].shape[1] != 3 for k in want[2]):
        raise AssertionError('the flagship aug must visualise the flow')

    big = torch.zeros(RATE_B, 3, 2, 1, 1, device=dev)
    rate_draws = aug.draw(torch.Generator(device=dev).manual_seed(8), big, big)
    rates = {}
    for branch in 'qk':
        for name, taken in aug_rates(rate_draws[branch]).items():
            p, rate = AUG_RATES[name], float(taken.float().mean())
            rates[f'{branch}_{name}'] = rate
            if abs(rate - p) > 4 * math.sqrt(p * (1 - p) / RATE_B):
                raise AssertionError(f'{branch} {name} rate {rate} vs {p}')

    timing = {}
    for dtype in (torch.float32, torch.bfloat16):
        inputs = aug_inputs(dev, dtype)
        name = str(dtype).split('.')[-1]
        timing[f'{name}_ms'] = time_ms(lambda: aug(gen, *inputs), iters=10)
        out = aug(gen, *inputs)
        if out[0].dtype != dtype or out[2]['flow_imgs_q'].dtype != dtype:
            raise AssertionError(f'ssl_aug output dtype in a {dtype} call')
    # bytes the aug must move at least: each clip and flow read once, each
    # output written once (flows leave with 3 channels), in float32
    n_img, n_flow = (sum(x.numel() for x in card[:2]),
                     sum(x.numel() for x in card[2].values()))
    min_bytes = 4 * (2 * n_img + n_flow * 5 // 2)

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode('error')
    try:
        aug(gen, *card)
    finally:
        torch.cuda.set_sync_debug_mode('default')
    torch.cuda.synchronize()
    log(phase='ssl_aug', aug=type(aug).__name__, batch=32,
        card_vs_cpu_max_abs_clip=img_err,
        card_vs_cpu_flow={k: dict(max_abs=v[0], flips=v[1])
                          for k, v in flow.items()},
        rates_b4096=rates, **timing, min_bytes=min_bytes,
        bytes_bound_ms=min_bytes / HBM_BYTES_PER_S * 1e3,
        sync_debug='error: no host synchronisation')


def replayed_draws(aug, batches, seed):
    """One set of the aug's draws for each batch, made once on the CPU, so
    that the card and the CPU run the same augmentation."""
    gen = torch.Generator().manual_seed(seed)
    out = []
    for batch in batches:
        im = torch.from_numpy(batch['imgs'][0])
        out.append(aug.draw(gen, im, im))
    return out


def phase_card_vs_cpu():
    """Two train steps of a narrow model on the card and on the CPU, from
    the same weights and batches, with IdentityAug and with V5 (the same
    draws on both)."""
    batches = [flagship_batch(4, hw=32, seed=s) for s in (1, 2)]
    for aug_cfg in (dict(type='IdentityAug'), dict(FLAGSHIP_AUG,
                                                   crop_size=32)):
        card_vs_cpu(narrow_flagship_cfg(aug=aug_cfg), batches)


def card_vs_cpu(cfg, batches):
    logs = {}
    draws = None
    for dev in ('cpu', 'cuda'):
        model = build_model_from_cfg(cfg, device=dev, seed=1)
        if cfg['aug']['type'] != 'IdentityAug':
            if draws is None:
                draws = replayed_draws(model.aug, batches, seed=3)
            queue = iter(draws)
            model.aug.draw = (lambda gen, im_q, im_k, aux_info=None, q=queue:
                              tree_to(next(q), im_q.device))
        opt = build_optimizer(
            model, dict(type='SGD', lr=0.02, momentum=0.9,
                        weight_decay=1e-4),
            build_lr_schedule(dict(policy='CosineAnnealing', min_lr=0), 0.02,
                              400, 100),
            grad_clip=dict(max_norm=40), freeze_patterns=MOCO_FREEZE)
        step = make_train_step(model, opt, build_ema_fn(model))
        logs[dev] = [{k: v.item() for k, v in step(to_torch(
            batch, dev)).items()} for batch in batches]
        logs[dev + '_queue'] = model.recognizer_flow.queue.cpu()
    worst = 0.0
    for cpu, card in zip(logs['cpu'], logs['cuda']):
        for k in LOSS_KEYS + ['loss']:
            torch.testing.assert_close(torch.tensor(card[k]),
                                       torch.tensor(cpu[k]), **STEP_TOL)
            worst = max(worst, abs(card[k] - cpu[k]))
    torch.testing.assert_close(logs['cuda_queue'], logs['cpu_queue'],
                               **STEP_TOL)
    log(phase='card_vs_cpu', aug=cfg['aug']['type'], steps=2,
        max_abs_loss_diff=worst,
        **{f'loss_step{i + 1}': v['loss'] for i, v in
           enumerate(logs['cuda'])})


def phase_raft_card_vs_cpu():
    """RAFT at full width on the card and on the CPU, from the same seeded
    weights and images: 64x64, 4 levels, radius 4, 3 iterations."""
    rng = np.random.default_rng(2)
    img1 = rng.uniform(0, 255, (2, 3, 64, 64)).astype(np.float32)
    img2 = np.roll(img1, (3, -2), axis=(2, 3)) + rng.normal(
        scale=4.0, size=img1.shape).astype(np.float32)
    flows = {}
    for dev in ('cpu', 'cuda'):
        model = build_raft(device=dev, seed=1, iters=3)
        with torch.inference_mode():
            flows[dev] = [f.cpu() for f in model(*(
                torch.from_numpy(x).to(dev) for x in (img1, img2)))]
    for cpu, card in zip(flows['cpu'], flows['cuda']):
        torch.testing.assert_close(card, cpu, **RAFT_TOL)
    diff = [(card - cpu).abs().max().item()
            for cpu, card in zip(flows['cpu'], flows['cuda'])]
    log(phase='raft_card_vs_cpu', hw=64, iters=3,
        max_abs_flow=flows['cpu'][1].abs().max().item(),
        max_abs_diff_low=diff[0], max_abs_diff_up=diff[1])


def phase_flagship(dev, dtype):
    """The flagship config's own model (SyncMoCoAugmentV5, 3-channel flow
    stem) in the compute dtype."""
    cfg = load_flagship_config()
    model = build_model_from_cfg(cfg.model.to_dict(), device=dev, seed=0,
                                 dtype=dtype)
    if model.recognizer_flow.encoder_q.stem[0].in_channels != 3:
        raise AssertionError('the flagship flow stem must take 3 channels')
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

    reset_launch_counts()
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
    name = str(dtype).split('.')[-1]
    log(phase='flagship_step', dtype=name, aug=type(model.aug).__name__,
        steps=STEPS, batch=bs, K=model.recognizer.K, step_ms=step_ms,
        peak_bytes=peak, launches=launches, state=state,
        losses=[{k: lv[k] for k in LOSS_KEYS + ['loss']} for lv in losses])
    profile(f'flagship_step_{name}', lambda: step(batch))
    del model, opt, step, batch
    torch.cuda.empty_cache()
    return launches


def phase_flow_extraction():
    """RAFT large through the extraction entry point, on synthetic frame
    pairs (the second frame the first shifted, plus noise)."""
    raft_fn = make_raft_fn(None, iters=RAFT_ITERS)
    rng = np.random.default_rng(3)
    h, w = EXTRACT_HW
    batches = []
    for _ in range(EXTRACT_BATCHES):
        img1 = rng.integers(0, 256, (EXTRACT_PAIRS, h, w, 3), dtype=np.uint8)
        img2 = np.clip(np.roll(img1, (2, -3), axis=(1, 2)).astype(np.int16) +
                       rng.integers(-8, 9, img1.shape), 0, 255).astype(
                           np.uint8)
        batches.append((img1, img2))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    reset_launch_counts()
    batch_ms, flow_max = [], 0.0
    for img1, img2 in batches:
        t0 = time.perf_counter()
        flow = raft_fn(img1, img2)       # numpy: the copy back synchronises
        batch_ms.append((time.perf_counter() - t0) * 1e3)
        if flow.shape != (EXTRACT_PAIRS, h, w, 2) or \
                not np.isfinite(flow).all():
            raise AssertionError(f'flow {flow.shape}, finite '
                                 f'{np.isfinite(flow).all()}')
        flow_max = max(flow_max, float(np.abs(flow).max()))
    launches = cl.corr_lookup.launches
    if launches != RAFT_ITERS * EXTRACT_BATCHES:
        raise AssertionError(f'corr_lookup launches {launches} != '
                             f'{RAFT_ITERS * EXTRACT_BATCHES}')
    steady = batch_ms[1:]
    log(phase='flow_extraction', batches=EXTRACT_BATCHES,
        pairs=EXTRACT_PAIRS, hw=list(EXTRACT_HW), iters=RAFT_ITERS,
        batch_ms=batch_ms,
        pairs_per_s=EXTRACT_PAIRS * len(steady) / sum(steady) * 1e3,
        peak_bytes=torch.cuda.max_memory_allocated(), launches=launches,
        max_abs_flow=flow_max)
    profile('flow_extraction', lambda: raft_fn(*batches[0]))
    return launches


def _kernel_class(name):
    """Class of a device kernel by its name; the first match wins, so BN
    and resize kernels that cuDNN or a conv-like name carries come first."""
    n = name.lower()
    for cls, keys in (('decayed_infonce', ('l_neg_kernel', 'dq_partial',
                                           'dq_reduce')),
                      ('corr_lookup', ('corr_lookup',)),
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


def profile(path, fn):
    """Device time by kernel class over one more call of a path, and the
    device's busy share of that call's wall time."""
    from torch.profiler import ProfilerActivity
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_class, top = {}, []
    for e in prof.key_averages():
        if getattr(e, 'device_type', None) != torch.autograd.DeviceType.CUDA:
            continue
        us = device_us(e)
        cls = _kernel_class(e.key)
        by_class[cls] = by_class.get(cls, 0.0) + us / 1e3
        top.append((us / 1e3, e.count, e.key[:90]))
    busy = sum(by_class.values())
    top.sort(reverse=True)
    log(phase='profile', path=path, wall_ms=wall_ms, device_busy_ms=busy,
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
    corr = phase_corr_lookup(dev)
    mxu = phase_mxu_fill(dev)
    mxu_launches = phase_mxu_fill_tool()
    phase_conv_yardstick(dev)
    phase_ssl_aug(dev)
    phase_card_vs_cpu()
    phase_raft_card_vs_cpu()
    launches = phase_flagship(dev, torch.float32)
    phase_flagship(dev, torch.bfloat16)
    corr_launches = phase_flow_extraction()

    # the TPU functions that reach pl.pallas_call, and the row of each
    # kernel at the shape its main path gives it
    rows.append(dict(corr['extraction_16x22'], name='corr_lookup'))
    replaces = {'decayed_infonce_l_neg': 'mscl_tpu/ops/decayed_infonce.py:62',
                'decayed_infonce_dq': 'mscl_tpu/ops/decayed_infonce.py:86',
                'corr_lookup': 'mscl_tpu/ops/corr_lookup.py:336 '
                               '(corr_lookup_pallas_v2) and '
                               'mscl_tpu/ops/corr_lookup.py:198 '
                               '(corr_lookup_pallas)'}
    counts = {'decayed_infonce_l_neg': launches['l_neg'],
              'decayed_infonce_dq': launches['dq'],
              'corr_lookup': corr_launches}
    sources = {'decayed_infonce_l_neg': 'mscl_torch/csrc/decayed_infonce.cu',
               'decayed_infonce_dq': 'mscl_torch/csrc/decayed_infonce.cu',
               'corr_lookup': 'mscl_torch/csrc/corr_lookup.cu'}
    for name, _, _ in MXU_ROWS:
        kind = name[len('mxu_fill_'):]
        rows.append(mxu[name])
        replaces[name] = ('tools/analysis/bench_mxu_fill.py:'
                          f'{MXU_REPLACES[kind]}')
        counts[name] = mxu_launches[kind]
        sources[name] = 'mscl_torch/csrc/mxu_fill.cu'
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    print(json.dumps({'kernels': [dict(
        name=r['name'], route='cuda', source=sources[r['name']],
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
