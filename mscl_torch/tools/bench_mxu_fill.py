"""Tensor-core fill probes at r3d_18 layer1's implicit-GEMM geometry.

    python -m mscl_torch.tools.bench_mxu_fill [--iters N] [--carry | --kchain]
        [--device cpu] [--steps S]

Port of ``main()`` of ``tools/analysis/bench_mxu_fill.py``: the same three
case lists under the same names, M=3248 rows, 27 taps (28 for ``--kchain``,
so every pair is full; the reported rate is raw), and
``steps = max(8, int(2e13 / flops_of_one_pass))``. Inputs are normal bf16
from a seeded ``torch.Generator``, the weights scaled by 0.05. Each case runs
once, then ``--iters`` more times; the best time is reported as the JAX tool
prints it (name, steps, ms, TF/s), then, on the card, as a share of its
989 TFLOP/s dense bf16 peak.

It runs on the card (kernel times from CUDA events) unless given
``--device cpu``, where the probes' plain versions run and are timed on the
host clock; ``--steps`` overrides the steps of every case.
"""
from __future__ import annotations

import argparse
import time
from typing import NamedTuple

import torch

from ..apis.train import resolve_device
from ..ops import mxu_fill as mf

PEAK_BF16_FLOP_PER_S = 989e12     # H100 SXM, dense
M, INNER, KCHAIN_INNER = 3248, 27, 28
FLOP_PER_CASE = 2e13


class Case(NamedTuple):
    name: str
    kind: str      # a key of mxu_fill.ENTRY_POINTS
    shape: dict    # the entry point's shape parameters but m


def cases(mode):
    """The JAX tool's case list for mode '' (the tap loop), 'carry' or
    'kchain'."""
    if mode == 'kchain':
        # 7/14/28 taps of 64 channels: the saturation curve
        return [Case(f'bigdot  K={kk:4d} N=64 ', 'bigdot', dict(k=kk, n=64))
                for kk in (448, 896, 1792)] + [
            Case('bigdot  K=1792 N=128', 'bigdot', dict(k=1792, n=128))] + [
            Case(name, kind, dict(k=64, n=n, inner=KCHAIN_INNER))
            for name, kind, n in (('imcat   28x64  N=64 ', 'imcat', 64),
                                  ('imcat   28x64  N=128', 'imcat', 128),
                                  ('paircat 14x128 N=64 ', 'paircat', 64),
                                  ('paircat 14x128 N=128', 'paircat', 128))]
    if mode == 'carry':
        return [Case(name, 'carry', dict(mt=mt, k=k, n=64, inner=INNER))
                for name, mt, k in (
                    ('carry mt=112 K=64  N=64 ', 112, 64),
                    ('carry mt=464 K=64  N=64 ', 464, 64),
                    ('carry mt=112 K=128 N=64 ', 112, 128),
                    ('carry mt=464 K=128 N=64 ', 464, 128),
                    ('carry mt=1624 K=128 N=64', 1624, 128))]
    return [Case(name, 'probe', dict(k=k, n=n, inner=INNER))
            for name, k, n in (('K=64  N=64 ', 64, 64),
                               ('K=128 N=64 ', 128, 64),
                               ('K=256 N=64 ', 256, 64),
                               ('K=128 N=128', 128, 128),
                               ('K=256 N=128', 256, 128))]


def flops_per_pass(case):
    s = case.shape
    return 2 * M * s['k'] * s['n'] * s.get('inner', 1)


def default_steps(case):
    return max(8, int(FLOP_PER_CASE / flops_per_pass(case)))


def inputs(case, device='cpu', seed=0):
    """x and w of a case: normal bf16 from a generator seeded with seed,
    the weights scaled by 0.05."""
    x_shape, w_shape = mf._shapes(case.kind, M, **case.shape)
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(x_shape, generator=g, dtype=torch.bfloat16)
    w = torch.randn(w_shape, generator=g, dtype=torch.bfloat16) * 0.05
    return x.to(device), w.to(device)


def call(case, x, w, steps=1):
    """The case's entry point on (x, w): its kernel for CUDA tensors, its
    plain version for CPU ones."""
    return mf.ENTRY_POINTS[case.kind](x, w, m=M, steps=steps, **case.shape)


def run_case(case, iters, device, steps=None):
    steps = default_steps(case) if steps is None else steps
    x, w = inputs(case, device)
    cuda = device.type == 'cuda'
    call(case, x, w, steps)
    if cuda:
        torch.cuda.synchronize(device)
    best = float('inf')
    for _ in range(iters):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            call(case, x, w, steps)
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            call(case, x, w, steps)
            best = min(best, time.perf_counter() - t0)
    flops = flops_per_pass(case) * steps
    rate = flops / best
    line = (f'{case.name} steps={steps:5d} {best * 1e3:8.2f} ms '
            f'{rate / 1e12:6.1f} TF/s')
    result = dict(name=case.name.strip(), kind=case.kind, steps=steps,
                  ms=best * 1e3, tflops=rate / 1e12, device=str(device))
    if cuda:
        result['peak_share'] = rate / PEAK_BF16_FLOP_PER_S
        line += f' {100 * result["peak_share"]:5.1f} % of 989 TF/s'
    else:
        line += ' (CPU, plain version)'
    print(line, flush=True)
    return result


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--iters', type=int, default=3)
    mode = p.add_mutually_exclusive_group()
    mode.add_argument('--carry', action='store_true',
                      help='loop-carried (register) accumulator variant')
    mode.add_argument('--kchain', action='store_true',
                      help='K-concat variants: bigdot / imcat / paircat at '
                           'the layer1 im2col geometry')
    p.add_argument('--steps', type=int, default=None,
                   help='steps of every case (default: max(8, 2e13 / the '
                        'FLOP of one pass))')
    p.add_argument('--device', default=None,
                   help="torch device (default: the card; 'cpu' runs the "
                        'plain versions)')
    return p.parse_args(argv)


def main(argv=None):
    """Run a case list; returns one result dict per case."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    mode = 'kchain' if args.kchain else 'carry' if args.carry else ''
    return [run_case(case, args.iters, device, args.steps)
            for case in cases(mode)]


if __name__ == '__main__':
    main()
