"""Inference speed of a recognizer config on the card.

    python -m mscl_torch.tools.benchmark CONFIG [--log-interval 10]
        [--iterations 50] [--batch-size B] [--shape S ...]
        [--cfg-options ...] [--device cuda|cpu]

Port of ``tools/analysis/benchmark.py`` (reference
tools/analysis/benchmark.py:30-50): the model from seed 0 (no
``train_cfg``), a synthetic batch of the test geometry (``--shape``: the
batch as the recognizer takes it; by default the JAX tool's
(B, 1, 3, 16, 112, 112) clips, B from ``--batch-size`` or the config's
``videos_per_gpu``), three warm-up calls, then ``forward_test`` timed
``--iterations`` times, each to a synchronise. Prints seconds an
iteration and videos a second every ``--log-interval`` and overall.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..config import Config, DictAction


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description='Benchmark inference')
    parser.add_argument('config')
    parser.add_argument('--log-interval', type=int, default=10)
    parser.add_argument('--iterations', type=int, default=50)
    parser.add_argument('--batch-size', type=int, default=None)
    parser.add_argument('--shape', type=int, nargs='+', default=None,
                        help='the input batch shape (default: B 1 3 16 '
                             '112 112)')
    parser.add_argument('--cfg-options', nargs='+', action=DictAction,
                        default={})
    parser.add_argument('--device', default='cuda',
                        help="'cuda' (the default) or 'cpu'")
    return parser.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    """Returns the seconds of each timed iteration, the batch size and the
    videos a second."""
    args = parse_args(argv)
    cfg = Config.fromfile(args.config)
    if args.cfg_options:
        cfg.merge_from_dict(args.cfg_options)
    from ..apis.inference import init_recognizer
    model, cfg = init_recognizer(cfg, None, device=args.device)
    dev = next(model.parameters()).device
    bs = args.batch_size or cfg.data['videos_per_gpu']
    shape = tuple(args.shape) if args.shape else (bs, 1, 3, 16, 112, 112)
    bs = shape[0]
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)

    def sync():
        if dev.type == 'cuda':
            torch.cuda.synchronize(dev)

    with torch.no_grad():
        for _ in range(3):
            model.forward_test(x)
        sync()
        times = []
        for i in range(args.iterations):
            t0 = time.perf_counter()
            model.forward_test(x)
            sync()
            times.append(time.perf_counter() - t0)
            if (i + 1) % args.log_interval == 0:
                print(f'iter {i + 1}: {np.mean(times):.4f} s/iter '
                      f'({bs / np.mean(times):.1f} videos/s)')
    print(f'overall: {np.mean(times):.4f} s/iter, '
          f'{bs / np.mean(times):.1f} videos/s')
    return dict(times=times, batch=bs, videos_per_s=bs / np.mean(times),
                device=str(dev))


if __name__ == '__main__':
    main()
