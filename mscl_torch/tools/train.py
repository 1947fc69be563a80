"""Train a recognizer from a config file on one card.

    python -m mscl_torch.tools.train CONFIG [--work-dir DIR]
        [--resume-from CKPT] [--validate] [--seed N] [--max-epochs N]
        [--cfg-options key=value ...] [--device cuda|cpu]

Port of ``tools/train.py`` (reference mmaction tools/train.py:79-196): load
the config, merge ``--cfg-options``, dump the merged config into the work
dir, then ``train_model``. It runs on the card; ``--device cpu`` runs it on
the CPU. The flags of the JAX tool's multi-device and multi-host runs
(``--num-devices``, ``--coordinator``, ``--num-hosts``, ``--host-id``) are
refused: data-parallel training is not ported.
"""
from __future__ import annotations

import argparse
import os
import os.path as osp
from typing import Optional, Sequence

from ..config import Config, DictAction

_NOT_PORTED = ('num_devices', 'coordinator', 'num_hosts', 'host_id')


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
    parser.add_argument('--num-devices', type=int, default=None)
    parser.add_argument('--coordinator', default=None)
    parser.add_argument('--num-hosts', type=int, default=None)
    parser.add_argument('--host-id', type=int, default=None)
    parser.add_argument('--cfg-options', nargs='+', action=DictAction,
                        default={},
                        help='override config entries key=value')
    parser.add_argument('--device', default='cuda',
                        help="'cuda' (the default) or 'cpu'")
    args = parser.parse_args(argv)
    for name in _NOT_PORTED:
        if getattr(args, name) is not None:
            parser.error(f'--{name.replace("_", "-")} is not supported: the '
                         f'port trains on one card (data-parallel training '
                         f'is not ported)')
    return args


def main(argv: Optional[Sequence[str]] = None):
    args = parse_args(argv)
    cfg = Config.fromfile(args.config)
    if args.cfg_options:
        cfg.merge_from_dict(args.cfg_options)
    if args.work_dir:
        cfg.work_dir = args.work_dir
    elif cfg.get('work_dir') is None:
        cfg.work_dir = osp.join(
            './work_dirs', osp.splitext(osp.basename(args.config))[0])
    os.makedirs(cfg.work_dir, exist_ok=True)
    cfg.dump(osp.join(cfg.work_dir, osp.basename(args.config)))

    from ..apis.train import train_model
    return train_model(cfg, validate=args.validate,
                       resume_from=args.resume_from, seed=args.seed,
                       max_epochs=args.max_epochs, device=args.device)


if __name__ == '__main__':
    main()
