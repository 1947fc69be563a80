"""Train a recognizer from a config file, data-parallel over the cards.

    python -m mscl_torch.tools.train CONFIG [--work-dir DIR]
        [--resume-from CKPT] [--validate] [--seed N] [--max-epochs N]
        [--cfg-options key=value ...] [--device cuda|cpu]
        [--num-devices N] [--coordinator HOST:PORT --num-hosts H
         --host-id I]
    torchrun --nproc-per-node N -m mscl_torch.tools.train CONFIG ...

Port of ``tools/train.py`` (reference mmaction tools/train.py:79-196): load
the config, merge ``--cfg-options``, dump the merged config into the work
dir (rank 0), then ``train_model`` on every rank. It runs on the card;
``--device cpu`` runs it on the CPU. The multi-device flags are the JAX
tool's (``parallel/launch.py``): by default one rank a visible card, the
global batch ``videos_per_gpu`` x the ranks; one card runs with no process
group.
"""
from __future__ import annotations

import argparse
import os
import os.path as osp
from typing import Optional, Sequence

from ..config import Config, DictAction
from ..parallel import dist, launch


def parse_args(argv: Optional[Sequence[str]] = None):
    parser = argparse.ArgumentParser(description='Train a recognizer')
    parser.add_argument('config', help='train config file path')
    parser.add_argument('--work-dir', help='dir to save logs and ckpts')
    parser.add_argument('--resume-from',
                        help='checkpoint file to resume from')
    parser.add_argument('--validate', action='store_true',
                        help='evaluate during training')
    parser.add_argument('--seed', type=int, default=None)
    parser.add_argument('--deterministic', action='store_true',
                        help='accepted for CLI parity')
    parser.add_argument('--max-epochs', type=int, default=None,
                        help='override total_epochs (smoke runs)')
    launch.add_arguments(parser)
    parser.add_argument('--cfg-options', nargs='+', action=DictAction,
                        default={},
                        help='override config entries key=value')
    parser.add_argument('--device', default='cuda',
                        help="'cuda' (the default) or 'cpu'")
    args = parser.parse_args(argv)
    launch.check(parser, args)
    return args


def main(argv: Optional[Sequence[str]] = None):
    """Returns train_model's (runner, model) with one rank and no process
    group, else None."""
    args = parse_args(argv)
    return launch.run(_train, args, args)


def _train(args):
    cfg = Config.fromfile(args.config)
    if args.cfg_options:
        cfg.merge_from_dict(args.cfg_options)
    if args.work_dir:
        cfg.work_dir = args.work_dir
    elif cfg.get('work_dir') is None:
        cfg.work_dir = osp.join(
            './work_dirs', osp.splitext(osp.basename(args.config))[0])
    if dist.is_main():
        os.makedirs(cfg.work_dir, exist_ok=True)
        cfg.dump(osp.join(cfg.work_dir, osp.basename(args.config)))

    from ..apis.train import train_model
    out = train_model(cfg, validate=args.validate,
                      resume_from=args.resume_from, seed=args.seed,
                      max_epochs=args.max_epochs, device=args.device)
    return None if dist.is_distributed() else out


if __name__ == '__main__':
    main()
