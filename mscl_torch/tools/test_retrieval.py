"""Video retrieval: kNN Recall@{1,5,10,20,50} over pooled encoder
features, data-parallel over the cards.

    python -m mscl_torch.tools.test_retrieval CONFIG [CHECKPOINT] [--ssl]
        [--out JSON] [--cfg-options key=value ...] [--device cuda|cpu]
        [--num-devices N] [--coordinator ...]

Port of ``tools/test_retrieval.py`` (reference tools/test_retrival.py):
the train and test sets (``data.train`` and ``data.test``, or ``data.val``)
in test mode, each video's pooled feature (``extract_features_pooled``),
then ``retrieval_recall``. ``--ssl`` takes the weights from the config's
``model.train_cfg.ssl_pretrain`` surgery instead of CHECKPOINT (reference
:147-148). Prints the recalls as JSON (and writes them to ``--out``).
The multi-device flags are the JAX tool's (``parallel/launch.py``): each
rank extracts its rows of each global batch, the features come back in
dataset order on every rank, and rank 0 computes the recalls, prints and
writes them.
"""
from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence

from ..config import Config, DictAction
from ..parallel import dist, launch


def parse_args(argv: Optional[Sequence[str]] = None):
    parser = argparse.ArgumentParser(description='Retrieval eval')
    parser.add_argument('config')
    parser.add_argument('checkpoint', nargs='?', default=None)
    parser.add_argument('--ssl', action='store_true',
                        help='init from the config ssl_pretrain surgery '
                             'instead of --checkpoint')
    parser.add_argument('--out', help='output result json')
    launch.add_arguments(parser)
    parser.add_argument('--cfg-options', nargs='+', action=DictAction,
                        default={})
    parser.add_argument('--device', default='cuda',
                        help="'cuda' (the default) or 'cpu'")
    args = parser.parse_args(argv)
    launch.check(parser, args)
    return args


def main(argv: Optional[Sequence[str]] = None):
    """Returns the recalls."""
    args = parse_args(argv)
    return launch.run(_retrieval, args, args)


def _retrieval(args):
    cfg = Config.fromfile(args.config)
    if args.cfg_options:
        cfg.merge_from_dict(args.cfg_options)

    from ..apis.inference import (extract_features, init_recognizer,
                                  retrieval_recall)
    from ..apis.train import _plain, apply_ssl_pretrain
    from .test import build_test_loader
    model, cfg = init_recognizer(
        cfg, None if args.ssl else args.checkpoint, device=args.device)
    ssl_cfg = (_plain(cfg.model).get('train_cfg') or {}).get('ssl_pretrain')
    if args.ssl and ssl_cfg:
        apply_ssl_pretrain(model, dict(ssl_cfg))

    feats = {}
    for split in ('train', 'test' if 'test' in cfg.data else 'val'):
        dataset, loader = build_test_loader(cfg, split)
        print(f'extracting {split} features...', flush=True)
        try:
            feats[split] = (extract_features(model, loader),
                            [v['label'] for v in dataset.video_infos])
        finally:
            loader.shutdown()
    (train_feats, train_labels), (test_feats, test_labels) = feats.values()
    metrics = None
    if dist.is_main():
        metrics = retrieval_recall(train_feats, train_labels, test_feats,
                                   test_labels,
                                   device=next(model.parameters()).device)
        print(json.dumps(metrics, indent=2))
        if args.out:
            with open(args.out, 'w') as f:
                json.dump(metrics, f)
    return dist.broadcast_object(metrics)


if __name__ == '__main__':
    main()
