"""Clip-level feature extraction: each video's pooled encoder feature over
a config's test set, written to an ``.npz``.

    python -m mscl_torch.tools.clip_feature_extraction CONFIG CHECKPOINT
        [--out features.npz] [--cfg-options key=value ...]
        [--device cuda|cpu] [--num-devices N] [--coordinator ...]

Port of ``tools/misc/clip_feature_extraction.py`` (reference
tools/misc/clip_feature_extraction.py): the test set (``data.test``, or
``data.val``) in test mode, the model from the config without its
train_cfg and with CHECKPOINT's weights (the port's ``epoch_N.pth``, a
reference ``.pth`` or a JAX ``epoch_N.ckpt``; ``''`` keeps the seed-0
init), ``apis.inference.extract_features`` (``extract_features_pooled``
a batch), then ``features`` (videos, C) float32 and ``labels`` (videos,),
-1 where a video has none, the JAX tool's keys. The multi-device flags are
the JAX tool's (``parallel/launch.py``): each rank extracts its rows of
each global batch, the features come back in dataset order, and rank 0
writes them.
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np

from ..config import Config, DictAction
from ..parallel import dist, launch


def parse_args(argv: Optional[Sequence[str]] = None):
    parser = argparse.ArgumentParser(description='Clip feature extraction')
    parser.add_argument('config')
    parser.add_argument('checkpoint', help="checkpoint path or ''")
    parser.add_argument('--out', default='features.npz')
    launch.add_arguments(parser)
    parser.add_argument('--cfg-options', nargs='+', action=DictAction,
                        default={})
    parser.add_argument('--device', default='cuda',
                        help="'cuda' (the default) or 'cpu'")
    args = parser.parse_args(argv)
    launch.check(parser, args)
    return args


def main(argv: Optional[Sequence[str]] = None):
    """Returns (features, labels)."""
    args = parse_args(argv)
    return launch.run(_extract, args, args)


def _extract(args):
    cfg = Config.fromfile(args.config)
    if args.cfg_options:
        cfg.merge_from_dict(args.cfg_options)

    from ..apis.inference import extract_features, init_recognizer
    from .test import build_test_loader
    model, cfg = init_recognizer(cfg, args.checkpoint or None,
                                 device=args.device)
    dataset, loader = build_test_loader(
        cfg, 'test' if 'test' in cfg.data else 'val')
    try:
        feats = extract_features(model, loader)[:len(dataset)]
    finally:
        loader.shutdown()
    labels = np.asarray([info.get('label', -1)
                         for info in dataset.video_infos])
    if dist.is_main():
        np.savez(args.out, features=feats, labels=labels)
        print(f'wrote {args.out}: features {feats.shape}, labels '
              f'{labels.shape}')
    return feats, labels


if __name__ == '__main__':
    main()
